from .attention import flash_attention  # noqa: F401
from .ops import flash_gqa, flash_gqa_ref  # noqa: F401
from .ref import attention_ref  # noqa: F401
