"""Model configs of the port; importing the package registers them."""
from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b,  # noqa: F401
                                 gemma2_27b, h2o_danube3_4b, jamba_v01_52b,
                                 minitron_4b, phi3_vision_4b, rwkv6_3b,
                                 semanticxr, whisper_small, yi_9b)
