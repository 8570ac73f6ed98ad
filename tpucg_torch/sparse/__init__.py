"""Sparse containers on the host (NumPy only)."""

from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix, DIAMatrix, csr_to_dia

__all__ = ["COOMatrix", "CSRMatrix", "DIAMatrix", "csr_to_dia"]
