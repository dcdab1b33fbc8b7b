"""Percent of the window's joins served from the packed-batch slot:
hits / (hits + stores + drops) of the program's PACK_CACHE_STATS over the
window. None where no join met the slot."""


def read(run):
    if run.cache_delta is None:
        return None
    c = run.cache_delta["pack_slot"]
    n = c["hits"] + c["stores"] + c["drops"]
    return 100.0 * c["hits"] / n if n else None
