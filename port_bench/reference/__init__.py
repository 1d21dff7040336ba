"""The plain reference the benchmark holds the port against: the same
architectures, their loss and AdamW in plain PyTorch, in float32 with
TF32 off, with no kernel, cache or batching of the program's.  It imports
nothing of the port, of JAX or of the JAX package; it is given the
benchmark's weights and tokens, never anything the program made.

``precision="fp8"`` runs it as the control: every matrix product's
operands rounded to float8 (e4m3 forward, e5m2 for gradients, one scale
a tensor), the next precision below the bfloat16 the configurations
state.  A comparison that cannot tell that apart from the reference is
too loose."""
