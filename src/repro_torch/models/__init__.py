"""Model zoo of the port: every model family of the reference."""
from .model_zoo import ModelBundle, PagedOps, build  # noqa: F401
