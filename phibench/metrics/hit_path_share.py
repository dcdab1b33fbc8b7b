"""Percent of the window's inferences whose anchors took the host hit path:
hits over all routes of the program's ANCHOR_ROUTE_STATS
(cache_counts()["anchor_route"]) over the window. None where the program
keeps no such counter, or no inference counted."""


def read(run):
    if run.cache_delta is None:
        return None
    c = run.cache_delta.get("anchor_route")
    if not c:
        return None
    n = sum(c.values())
    return 100.0 * c["hits"] / n if n else None
