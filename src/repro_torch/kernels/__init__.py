"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers (one module per kernel, each with its ``launches`` count), plain
PyTorch versions (``ref``) and device dispatch (``ops``, the entry points
the model calls).  Importing this package builds nothing; the first launch
on a CUDA tensor builds the library (``build``)."""
