"""Built-in HiCR frontends (paper §4.3): higher-level, ready-to-use features
built exclusively on calls to the HiCR core API — hence implementation-
agnostic and portable across backends. Own copies of `repro/frontends/`
with only the package prefix changed."""
from . import channels, dataobject, rpc, tasking  # noqa: F401

__all__ = ["channels", "dataobject", "rpc", "tasking"]
