"""The values of the bf16 options (``gram_matmul_dtype``,
``model_matmul_dtype``, ``opt_state_dtype``): None or 'bfloat16', the
names ``vgan_tpu``'s CLI offers."""

from __future__ import annotations

from typing import Optional

import torch

_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def low_precision(value: Optional[str], option: str) -> Optional[torch.dtype]:
    """The torch dtype of the bf16 option ``option`` set to ``value``;
    ``ValueError`` for anything but None or 'bfloat16'."""
    if value not in _DTYPES:
        raise ValueError(f"{option}={value!r}: expected one of {list(_DTYPES)}")
    return _DTYPES[value]
