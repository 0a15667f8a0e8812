"""The word language model example on the port."""
