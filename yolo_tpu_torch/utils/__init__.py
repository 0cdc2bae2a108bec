"""Utilities: the CUDA kernel build (``kernels``) and drawing (``visualization``).

Import the submodules directly; this package imports nothing, so that
loading it pulls in neither PIL nor a compiler.
"""
