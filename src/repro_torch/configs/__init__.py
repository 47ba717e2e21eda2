"""Model configs of the port; importing the package registers them."""
from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b,  # noqa: F401
                                 semanticxr)
