"""The shared Module-API training harness of the image-classification
examples."""
