"""k1_tests_per_query: the box tests the fused kernel's (K1's) scan
performed over the window, re-runs included, per query answered
(``QueryEngine.stats``: ``k1_scan_tests`` over ``queries``).  Each query
tile tests its 8 queries against every entry of each candidate tile it
scans; ``rrbench/bench/work.py`` counts the least tests a query needs.
A program without the counter reports nothing."""


def read(ctx):
    st = ctx["stats"]
    if "k1_scan_tests" not in st or st.get("queries", 0) <= 0:
        return None
    return st["k1_scan_tests"] / st["queries"]
