"""The fold conv's least time on an H100 SXM: copies of ``chip_smoke.py``'s
``valid_taps`` and ``bound`` (``channels`` added, defaulting to the
flagship's 32), with the data-sheet peaks they use.
``portbench/tests/test_portbench_copies.py`` holds them equal to the
originals and to hand counts.
"""

# H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

L, LP, C, K, B = 28, 55, 32, 2, 192  # the fold conv's serving shape (Lp = L + L - 1)


def valid_taps(periods, kh: int, kw: int, lp: int = LP, seq_len: int = L) -> int:
    """(output row, tap) pairs inside the fold grid of a ``seq_len``-step
    sequence, over the K candidates and ``lp`` rows each (``Lp`` on the
    dynamic path, ``total`` at the exact extent)."""

    total = 0
    for p in periods:
        cycles = -(-seq_len // p)
        for t in range(lp):
            row, col = divmod(t, p)
            total += sum(
                1 for dc in range(-(kh // 2), kh // 2 + 1) if 0 <= row + dc < cycles
            ) * sum(1 for dj in range(-(kw // 2), kw // 2 + 1) if 0 <= col + dj < p)
    return total


def bound(periods, kh: int, kw: int, dtype: str, batch: int = B, kind: str = "fwd",
          lp: int = LP, seq_len: int = L, channels: int = C):
    """Least time for one call on an H100 SXM: each input read once and the
    output written once over the memory rate, against the multiply-adds of
    the taps that these periods leave inside the grid over the peak rate of
    the input type. ``kind``: the forward (h, W, bias in; float32 out), the
    dh adjoint (ct, W in; float32 dh out) or the weight gradient (h, ct in;
    float32 dW out); all three do one multiply-add per valid (row, tap)
    pair and channel pair. K is ``len(periods)``, each over ``lp`` rows of
    a ``seq_len``-step fold. Returns (ms, bound_by, ms counting all kh*kw taps)."""

    C = channels
    k = len(periods)
    elt = 2 if dtype == "bfloat16" else 4
    act, w = k * batch * lp * C, kh * kw * C * C
    nbytes = {
        "fwd": act * elt + w * elt + C * 4 + 2 * k * 4 + act * 4,
        "dh": act * elt + w * elt + 2 * k * 4 + act * 4,
        "dw": 2 * act * elt + 2 * k * 4 + w * 4,
    }[kind]
    ops = 2 * batch * C * C * valid_taps(periods, kh, kw, lp, seq_len)
    ops_all = 2 * k * batch * lp * kh * kw * C * C
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    t_all = max(t_mem, ops_all / PEAK_OPS_PER_S[dtype])
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations"), 1e3 * t_all
