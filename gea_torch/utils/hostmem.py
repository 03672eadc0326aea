"""Host-memory guard for long runs (port of `gea/utils/hostmem.py`): when
the process's resident set crosses the budget, the trainer writes a
checkpoint and exits with code 19, so a supervisor, or the trainer's own
auto-resume on relaunch, continues from the exact step."""

from __future__ import annotations

EXIT_HOST_RSS = 19  # distinct from argparse (2) and a crash (1)


def host_rss_gb() -> float:
    """Current process resident set, in GB (decimal)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1e-6
    except OSError:
        pass
    return 0.0


def total_ram_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) * 1e-6
    except OSError:
        pass
    return 0.0


def resolve_rss_budget_gb(flag_value: float) -> float:
    """--max_host_rss_gb -> a budget: 0 is 85% of system RAM, a negative
    value disables the guard, a positive one is taken as is."""
    if flag_value < 0:
        return float("inf")
    if flag_value == 0:
        total = total_ram_gb()
        return 0.85 * total if total else float("inf")
    return flag_value
