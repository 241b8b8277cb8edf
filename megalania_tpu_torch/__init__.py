"""megalania_tpu_torch: the annealing LZMA compressor in PyTorch, with
its kernels written in CUDA C++ for NVIDIA Hopper (sm_90a).

megalania_tpu (JAX/Pallas) is the reference this package is held to, value
for value.  Importing the package builds nothing: the CUDA kernels and the
native host engines are compiled on first use (runtime/build.py).
"""
