"""``scene_build_s``, layer "scene build" (``models/builders.py``:
``SceneBuilder.build``, ``GridClothBatch.create``, ``GridTetBatch.create``):
the seconds of the program's scene build from the configuration, on the
harness's host clock, ending in a device sync. Moves ``setup_s``."""


def read(run):
    return run.scene_build_s
