"""Weight bridges into the port, and the model zoo's ``AutoModel``."""

from .modeling_auto import AutoModel  # noqa: F401
