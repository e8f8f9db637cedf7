"""scan_slots_per_tile: the engine's candidate scan slots per live
candidate tile over the window (``QueryEngine.stats``: ``tiles_grid`` over
``tiles_scanned``).  Every query tile is given as many slots as the
batch's fullest one needs; the slots past its own candidates are wasted
work, so 1 is the least."""


def read(ctx):
    st = ctx["stats"]
    if st.get("tiles_scanned", 0) <= 0:
        return None
    return st["tiles_grid"] / st["tiles_scanned"]
