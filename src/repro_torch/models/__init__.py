"""Model zoo of the port (transformer family only so far)."""
from .model_zoo import ModelBundle, PagedOps, build  # noqa: F401
