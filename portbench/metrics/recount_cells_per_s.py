"""recount_cells_per_s (cells/s, host clock): the grid cells (pods x pods
x port cases) of every recount that returned in the window, over the
window's seconds."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(s["counts"]["cells"] for s in run.recounts()) / run.window_s
