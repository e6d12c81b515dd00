"""HiCR applications of the paper's test cases (§5), ported. Each app is
written against the abstract HiCR manager API only, so the same program runs
on any backend combination. Only Test Case 2 (`mlp_inference`) is ported
so far; the reference's `fibonacci` and `jacobi` apps are not."""
from . import mlp_inference  # noqa: F401

__all__ = ["mlp_inference"]
