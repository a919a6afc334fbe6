"""The far list's size: one episode replayed from its start with the
far-field counters read after every frame; the mean over its frames of
each frame's largest list (``far_stats()["far_pairs"]`` is the largest
``n_pairs`` since the last read, over the frame's rebuilds).  Nothing
where no frame listed a pair."""


def read(ctx):
    frames = ctx.loop.far_per_frame()
    pairs = [f.get("far_pairs", 0) for f in frames]
    if not pairs or max(pairs) == 0:
        return None
    return sum(pairs) / len(pairs)
