"""The program under test: ``tpu_deflate_torch`` through its public API on
one device.  The benchmark reaches it only here; the control and the
planted faults (``control.py``) stand in its place with the same methods."""

from __future__ import annotations

import functools
import pathlib


class Port:
    def __init__(self, device: str):
        import tpu_deflate_torch

        self.td = tpu_deflate_torch
        self.device = device

    def config(self, fields: dict):
        return self.td.DeflateConfig(**fields)

    def __getattr__(self, name: str):
        """An entry point of the public API, on this device:
        ``port.compress_indexed(data, config)``."""
        td = self.__dict__.get("td")
        if td is None or name.startswith("_") or name not in td.__all__:
            raise AttributeError(name)
        return functools.partial(getattr(td, name), device=self.device)

    def csrc(self) -> pathlib.Path:
        """The folder of the program's CUDA sources."""
        return pathlib.Path(self.td.__file__).parent / "csrc"
