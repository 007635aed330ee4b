"""Scene I/O (port of ``positionbaseddynamics_tpu.scene``): the
reference's JSON scene format → a built simulation on the card (or on the
CPU when asked).

``load_scene`` reads the schema of ``Utils/SceneLoader.h:180-205`` /
``doc/file_format.md`` and reproduces the build semantics of
``Demos/SceneLoaderDemo/SceneLoaderDemo.cpp:47-105,380-860``.
"""
from .loader import LoadedScene, load_scene, load_scene_dict

__all__ = ["LoadedScene", "load_scene", "load_scene_dict"]
