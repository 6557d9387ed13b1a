"""Model parameter summary (reference models/utils.py:4-24), over
named_parameters."""

from __future__ import annotations


def model_summary(model, name: str = "model") -> int:
    """Print a named-parameter table + totals; returns total param count."""
    print("--------------------------------------------")
    total = 0
    for pname, p in model.named_parameters():
        n = p.numel()
        total += n
        print(f"{pname:60s} {str(tuple(p.shape)):20s} {n:>10d}")
    print("--------------------------------------------")
    print(f"Total params ({name}): {total}")
    return total
