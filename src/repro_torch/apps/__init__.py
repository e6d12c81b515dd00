"""HiCR applications of the paper's test cases (§5), ported. Each app is
written against the abstract HiCR manager API only, so the same program runs
on any backend combination. Test Cases 3 and 4 (`fibonacci`, `jacobi`) are
own copies of the reference's host programs (numpy tasks over `hostcpu`,
`coroutine` and `localsim`); Test Case 2 (`mlp_inference`) also runs on
`torchdev` and the `fused_linear` kernel."""
from . import fibonacci, jacobi, mlp_inference  # noqa: F401

__all__ = ["fibonacci", "jacobi", "mlp_inference"]
