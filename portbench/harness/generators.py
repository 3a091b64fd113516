"""The benchmark's data generators: copies of ``chip_smoke.py``'s
``simulate_demand`` and ``simulate_long``, which are numpy copies of
``tools/make_demand_benchmark.py::simulate`` and
``tools/make_long_context_benchmark.py::simulate`` (the same draws in the
same order). ``portbench/tests/test_portbench_copies.py`` holds them equal
to the originals.

A configuration names its generator by ``data.generator``, one of the
functions at the end of this file, and gives its keyword arguments in
``data.generator_args``. Each returns ``(stamps [T] datetime64[s], ids,
demand [T, N], observed [T, N])``.
"""

DEMAND_TEST_FILES, DEMAND_TEST_HISTORY, DEMAND_HORIZON = 5, 28, 7


def simulate_demand(np, seed: int = 7, n_stores: int = 8, n_menus: int = 24,
                    t_train: int = 560):
    """``tools/make_demand_benchmark.py::simulate`` with ``datetime64`` days in
    place of ``pd.date_range``: the same draws in the same order. Returns
    (days [T] datetime64[D], ids, demand [T, N] float64, observed [T, N])."""

    import math

    rng = np.random.default_rng(seed)

    def store_name(st: int) -> str:
        letter, block = chr(ord("A") + st % 26), st // 26
        return f"매장{letter}{block}" if block else f"매장{letter}"

    ids = [f"{store_name(st)}_메뉴{m + 1:02d}" for st in range(n_stores) for m in range(n_menus)]
    n = len(ids)
    total_days = t_train + DEMAND_TEST_FILES * DEMAND_HORIZON + DEMAND_TEST_HISTORY
    days = np.datetime64("2023-01-01") + np.arange(total_days)
    t = np.arange(total_days)
    dow = (days.astype(np.int64) + 3) % 7  # Monday 0: 1970-01-01 was a Thursday
    week_profiles = np.empty((n_stores, 7))
    for st in range(n_stores):
        if st % 2 == 0:
            prof = np.array([0.8, 0.8, 0.9, 1.0, 1.2, 1.6, 1.5])
        else:
            prof = np.array([1.3, 1.25, 1.2, 1.15, 1.1, 0.6, 0.5])
        week_profiles[st] = prof * rng.uniform(0.9, 1.1, 7)
    base = rng.lognormal(mean=2.0, sigma=0.9, size=n)
    store_scale = rng.lognormal(mean=0.0, sigma=0.4, size=n_stores)
    trend = rng.normal(0.0, 0.0004, size=n)
    annual_amp = rng.uniform(0.05, 0.3, size=n)
    annual_phase = rng.uniform(0, 2 * math.pi, size=n)
    alpha = rng.uniform(0.08, 0.5, size=n)
    intermittent = rng.random(n) < 0.15
    mu = np.empty((total_days, n))
    for j in range(n):
        st = j // n_menus
        annual = 1.0 + annual_amp[j] * np.sin(2 * math.pi * t / 365.25 + annual_phase[j])
        level = base[j] * store_scale[st] * np.exp(trend[j] * t)
        mu[:, j] = level * week_profiles[st][dow] * annual
    for st in range(n_stores):  # promotions
        starts = rng.integers(0, total_days - 3, rng.integers(8, 20))
        for start in starts:
            dur = int(rng.integers(1, 4))
            mu[start:start + dur, st * n_menus:(st + 1) * n_menus] *= rng.uniform(1.5, 3.0)
    lam = rng.gamma(1.0 / alpha[None, :], mu * alpha[None, :])
    demand = rng.poisson(lam).astype(np.float64)
    demand[:, intermittent] = np.where(
        rng.random((total_days, intermittent.sum())) < 0.55, 0.0, demand[:, intermittent])
    for st in range(n_stores):  # closures: whole store zero-days
        for c in rng.integers(0, total_days, rng.integers(5, 15)):
            demand[c, st * n_menus:(st + 1) * n_menus] = 0.0
    observed = rng.random((total_days, n)) >= 0.02  # rows missing from the CSV
    return days, ids, demand, observed


def simulate_long(np, seed: int, n_series: int, total: int):
    """``tools/make_long_context_benchmark.py::simulate`` over ``total`` hours
    with ``datetime64`` stamps: the same draws in the same order. Returns
    (the generator, stamps [T] datetime64[h], demand [T, N] float64,
    observed [T, N])."""

    import math

    rng = np.random.default_rng(seed)
    stamps = np.datetime64("2024-01-01T00", "h") + np.arange(total)
    days = stamps.astype("datetime64[D]")
    hour = (stamps - days).astype(np.int64)
    dow = (days.astype(np.int64) + 3) % 7
    t = np.arange(total)
    base = rng.lognormal(mean=1.6, sigma=0.7, size=n_series)
    daily_phase = rng.uniform(0, 2 * math.pi, n_series)
    daily_amp = rng.uniform(0.4, 0.9, n_series)
    weekly_amp = rng.uniform(0.1, 0.5, n_series)
    weekend_sign = np.where(rng.random(n_series) < 0.5, 1.0, -1.0)
    drift = rng.normal(0.0, 5e-5, n_series)
    alpha = rng.uniform(0.1, 0.45, n_series)
    mu = np.empty((total, n_series))
    weekend = (dow >= 5).astype(np.float64)
    for j in range(n_series):
        daily = 1.0 + daily_amp[j] * np.sin(2 * math.pi * hour / 24.0 + daily_phase[j])
        weekly = 1.0 + weekly_amp[j] * weekend_sign[j] * (weekend - 2.0 / 7.0)
        level = base[j] * np.exp(drift[j] * t)
        mu[:, j] = np.maximum(level * daily * weekly, 0.05)
    for _ in range(max(4, n_series // 2)):  # bursts
        j = rng.integers(0, n_series)
        start = rng.integers(0, total - 36)
        dur = int(rng.integers(6, 37))
        mu[start:start + dur, j] *= rng.uniform(1.8, 3.5)
    lam = rng.gamma(1.0 / alpha[None, :], mu * alpha[None, :])
    demand = rng.poisson(lam).astype(np.float64)
    observed = rng.random((total, n_series)) >= 0.01
    return rng, stamps, demand, observed


def demand_series(np, seed: int, n_stores: int, n_menus: int, t_train: int):
    """:func:`simulate_demand`'s table: ``n_stores * n_menus`` daily series
    over ``t_train`` days and the test files' days after them."""

    days, ids, demand, observed = simulate_demand(np, seed, n_stores, n_menus, t_train)
    return days.astype("datetime64[s]"), ids, demand, observed


def hourly_series(np, seed: int, n_series: int, total: int):
    """:func:`simulate_long`'s table: ``n_series`` hourly series over
    ``total`` hours, named ``S000``, ``S001``, ..."""

    _, stamps, demand, observed = simulate_long(np, seed, n_series, total)
    return stamps.astype("datetime64[s]"), [f"S{j:03d}" for j in range(n_series)], demand, observed
