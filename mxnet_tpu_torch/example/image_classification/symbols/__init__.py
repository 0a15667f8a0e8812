"""The networks of the image-classification examples, as Symbols."""
