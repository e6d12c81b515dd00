"""Query-key pairs a causal mask keeps."""


def pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """Pairs (i, j) with j <= q_offset + i, 0 <= i < sq, 0 <= j < skv."""
    total = 0
    full_from = max(0, skv - q_offset - 1)  # rows from here on see every key
    n_part = min(sq, full_from)
    # rows 0 .. n_part-1 see q_offset + i + 1 keys
    total += n_part * (q_offset + 1) + n_part * (n_part - 1) // 2
    total += (sq - n_part) * skv
    return total
