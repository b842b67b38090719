"""fps (end to end): every frame whose ``track`` call returned in the window,
over the window's seconds (the window ends with a synchronisation)."""


def read(run):
    return run.n_frames / run.window_s if run.window_s > 0 else None
