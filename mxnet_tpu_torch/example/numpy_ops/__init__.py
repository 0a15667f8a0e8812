"""The numpy-ops examples on the port: custom operators in numpy and in
CUDA-C compiled at run time."""
