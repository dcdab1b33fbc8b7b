"""Percent of the window's graph loads served from the held panel:
hits / (hits + loads) of the program's PANEL_CACHE_STATS over the window.
None where the program keeps no such counter, or no load met the slot."""


def read(run):
    if run.cache_delta is None:
        return None
    c = run.cache_delta.get("panel")
    if c is None:
        return None
    n = c["hits"] + c["loads"]
    return 100.0 * c["hits"] / n if n else None
