"""The plain reference of the benchmark: PyTorch in float32, TF32 off.

It imports nothing of the program, of the JAX package or of JAX, and
takes nothing the program made: the benchmark hands it the same weights
and inputs it hands the program.
"""
