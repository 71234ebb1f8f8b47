"""graph_pool_gib: the programs (utils/programs.py): the served model's
graph pool after the window, from ``program_stats()``."""


def read(ctx):
    programs = ctx.get("programs") or {}
    if not programs.get("programs"):
        return None
    return programs["pool_bytes"] / float(1 << 30)
