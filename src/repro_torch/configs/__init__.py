"""Model configs of the port; importing the package registers them."""
from repro_torch.configs import semanticxr  # noqa: F401
