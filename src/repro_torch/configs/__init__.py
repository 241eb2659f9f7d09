"""Registered architectures (importing this package registers them)."""
from repro_torch.configs import granite_3_8b  # noqa: F401
from repro_torch.configs import nemotron_4_15b  # noqa: F401
from repro_torch.configs import paper_mt_base  # noqa: F401
from repro_torch.configs import rwkv6_1_6b  # noqa: F401
from repro_torch.configs import stablelm_12b  # noqa: F401
from repro_torch.configs import starcoder2_7b  # noqa: F401
