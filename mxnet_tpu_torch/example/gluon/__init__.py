"""The gluon examples on the port."""
