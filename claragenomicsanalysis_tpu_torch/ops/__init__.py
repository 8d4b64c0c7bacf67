"""Device ops of the port: each hand-written kernel's wrapper beside its plain
PyTorch version (the two banded-NW kernels and their traceback decoders,
Myers, the POA kernels), the banded-NW dispatch and the kernel build; and
the mapper's sketch, index, matching and chaining as torch ops."""
