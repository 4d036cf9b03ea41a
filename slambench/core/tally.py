"""K1 launches tallied by the benchmark's own wrapper, so that the
roofline's work does not rest on a counter of the program.

:meth:`K1Tally.install` replaces ``knn`` (``pgslam_tpu_torch/ops/
knn.py``) in every loaded module of the program that imported it by
name with a wrapper that counts each launch on a CUDA device by its
``(nq, nr, k)``. The defining module keeps its own function, whose
launch counter is the program's. Installed for a traced window only.
"""

from __future__ import annotations

import collections
import sys

PACKAGE = "pgslam_tpu_torch"


class K1Tally:
    """Counts the launches on devices of ``device_type`` (K1 launches on
    CUDA devices only; the CPU runs its plain version)."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self.shapes = collections.Counter()
        self._undo = []

    def install(self) -> None:
        from pgslam_tpu_torch.ops import knn as K
        orig = K.knn
        shapes, device_type = self.shapes, self.device_type

        def knn(query, query_mask, reference, reference_mask, k=1,
                *a, **kw):
            if query.device.type == device_type:
                shapes[(int(query.shape[0]), int(reference.shape[0]),
                        int(k))] += 1
            return orig(query, query_mask, reference, reference_mask, k,
                        *a, **kw)

        for name, mod in list(sys.modules.items()):
            if (name.split(".")[0] == PACKAGE and mod is not K
                    and getattr(mod, "knn", None) is orig):
                setattr(mod, "knn", knn)
                self._undo.append(mod)
        self._orig = orig

    def remove(self) -> None:
        for mod in self._undo:
            mod.knn = self._orig
        self._undo = []

    def modules(self):
        return [m.__name__ for m in self._undo]
