"""The SSD detection example on the port."""
