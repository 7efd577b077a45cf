"""The bitmap-index deployment (Ambit Section 8.1) on the port.

Every bitmap of the config is drawn on the card (``datagen``), put into
the ``AmbitRuntime`` as a resident handle of a ``BitmapIndex`` (the put
shares the drawn tensor, so nothing crosses the host), and a query's plan
joins one ``BitmapIndex.query_plan`` a bitmap by the spec's AND, OR and NOT
(``compose``).
"""

from __future__ import annotations

from repro_torch.apps.bitmap_index import BitmapIndex
from repro_torch.core import BitVector

from .. import datagen
from . import compose


class Deployment:
    def __init__(self, cfg: dict, seed: int, runtime):
        n_users = int(cfg["n_users"])
        words = datagen.bitmap_words(cfg, seed, runtime.tensor_device)
        self.index = BitmapIndex(n_users, runtime=runtime)
        for i, name in enumerate(datagen.bitmap_names(cfg)):
            self.index.resident[name] = runtime.put(
                BitVector(words[i], n_users), name=name)

    def plan(self, spec):
        return compose(spec, self._bitmap)

    def _bitmap(self, element):
        if element[0] != "bitmap":
            raise ValueError(f"a bitmap deployment serves bitmaps, got "
                             f"{element!r}")
        return self.index.query_plan([element[1]])
