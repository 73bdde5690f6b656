"""The yardstick's arithmetic: the device peaks, and the operations and
bytes each model family's work needs (one module a family, found by the
configuration's `family` key). No count is read from the program."""
from __future__ import annotations

from typing import Optional

# Published dense peaks of one card (NVIDIA's H100 SXM data sheet, without
# sparsity), at the full power limit of 700 W.
PEAKS = {
    "H100": {"bf16_flop_per_s": 989e12, "hbm_byte_per_s": 3.35e12},
}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named `kind` (torch.cuda.get_device_name), or
    None for a card the table does not know."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None
