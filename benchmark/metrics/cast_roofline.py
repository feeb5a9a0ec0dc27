"""cast_roofline: the ray-casting kernels K1-K4's share of their
roofline, in %.

The bound is bytes only: each ray cast reads its origin, direction and
extent once (32 B) and writes one 4-byte result word, priced at the
published 3.35 TB/s of one H100 (SXM, 700 W). Every ray the program
counted is priced so; a closest-hit ray's further 12 B (primitive,
barycentrics) are not counted, so the share is a lower bound. No
operations are counted: a walk of a hierarchy has no count that does not
depend on its implementation. Time: K1-K4's device time in the profiled
frames."""

HBM_BYTES_PER_S = 3.35e12
BYTES_PER_RAY = 36


def read(rec):
    p = rec.profile
    if p is None or not p.whole or p.hand_s <= 0 or p.rays <= 0:
        return None
    return 100.0 * (p.rays * BYTES_PER_RAY / HBM_BYTES_PER_S) / p.hand_s
