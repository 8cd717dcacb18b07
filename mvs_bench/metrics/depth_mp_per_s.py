"""``depth_mp_per_s``: V·H·W of every scene whose maps reached the host in
the window, over the window, from its first capture's start to the last
scene's maps on the host (host clock)."""


def read(run):
    if not run.window:
        return None
    return len(run.window) * run.scene_mp / (run.window[-1][2] - run.window[0][1])
