"""The port of the JAX package's ``example/svm_mnist/``."""
