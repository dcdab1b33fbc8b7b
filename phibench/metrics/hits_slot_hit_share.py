"""Percent of the window's hit-path joins served from the packed-batch
slot: hits / (hits + stores + misses) of the program's HITS_SLOT_STATS
(cache_counts()["hits_slot"]) over the window. None where the program
keeps no such counter, or no hit-path join counted."""


def read(run):
    if run.cache_delta is None:
        return None
    c = run.cache_delta.get("hits_slot")
    if c is None:
        return None
    n = c["hits"] + c["stores"] + c["misses"]
    return 100.0 * c["hits"] / n if n else None
