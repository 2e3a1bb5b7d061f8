"""Hand-written CUDA kernels of the counting path and their plain torch twins.

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and counts its kernel launches in a module-level ``LAUNCHES``.
"""
