"""frontend.parse_s: seconds of gdpt_tpu_torch.scene.parser.parse_scene
on the cell's scene file (XML, PLY meshes, the scene's tables and the
BVH), by the benchmark's host timer around the call."""


def read(rec):
    return rec.parse_s
