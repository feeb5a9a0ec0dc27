"""msamples_per_s: pixel samples (width x height x spp of each frame) of
every frame in the window, in millions, over the window's whole time."""


def read(rec):
    samples = sum(f.spp for f in rec.frames) * rec.width * rec.height
    return samples / 1e6 / rec.window_s
