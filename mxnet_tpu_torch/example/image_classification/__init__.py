"""The image-classification examples on the port."""
