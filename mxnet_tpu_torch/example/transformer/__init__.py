"""The transformer examples on the port."""
