"""The plain reference: conjugate gradients in plain PyTorch, from the
original arrays the harness hands the program. It imports nothing of the
program (``tpucg_torch``), of ``tpucg`` or of JAX."""
