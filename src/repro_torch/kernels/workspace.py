"""Split workspaces of the port's kernels.

``crossbar_matmul``'s split-K kernels, the transposed crossbar kernel's
split-N blocks, the flash kernels' split-KV blocks and the flash backward's
split key and row tiles sum partial results through a workspace that the
wrapper owns: f32 partials and int32 tickets. The tickets are zeroed once,
when allocated, and every call leaves them at 0, so calls that run in
order share one workspace: each kernel source has one per device, for
every stream. The
port runs its calls in order on one stream (a CUDA graph is captured on a
side stream, but capture records without running).

A call that needs more than the workspace holds replaces it with a larger
one, unless a CUDA graph is being captured: a graph keeps the pointers it
captured, so a call under capture that needs more raises, and the serving
engine ``reserve``s the most that any of its steps needs before its first
capture. A buffer that a graph captured is kept alive when it is replaced.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import torch

Need = Tuple[int, int]                  # (f32 partials, int32 tickets)
Buffers = Tuple[torch.Tensor, torch.Tensor]


class Workspaces:
    """The workspaces of one kernel source, one per device."""

    def __init__(self, name: str):
        self.name = name
        self._ws: Dict[int, Buffers] = {}
        self._captured: Set[int] = set()     # devices whose buffer a graph holds
        self._retired: List[Buffers] = []

    def pointers(self, need: Need, dev: int) -> Tuple[int, int, int, int]:
        """(partials, their count, tickets, their count) for a call that
        needs ``need``; all 0 when it needs none."""
        if need == (0, 0):
            return 0, 0, 0, 0
        ws = self._ws.get(dev)
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and (ws is None or not _covers(ws, need)):
            have = (ws[0].numel(), ws[1].numel()) if ws is not None else None
            raise RuntimeError(
                f"{self.name}: a captured call needs a workspace of {need} "
                f"(f32 partials, int32 tickets); cuda:{dev} holds {have}. "
                f"Reserve it before the capture.")
        ws = self.reserve(dev, need)
        if capturing:
            self._captured.add(dev)
        return ws[0].data_ptr(), ws[0].numel(), ws[1].data_ptr(), ws[1].numel()

    def reserve(self, dev: int, need: Need) -> Buffers:
        """Device ``dev``'s workspace, replaced by a larger one first when
        it holds less than ``need``."""
        ws = self._ws.get(dev)
        if ws is not None and _covers(ws, need):
            return ws
        if ws is not None:
            need = (max(need[0], ws[0].numel()), max(need[1], ws[1].numel()))
            if dev in self._captured:    # graphs captured on it still run
                self._retired.append(ws)
                self._captured.discard(dev)
        device = torch.device("cuda", dev)
        ws = self._ws[dev] = (
            torch.empty(max(need[0], 1), dtype=torch.float32, device=device),
            torch.zeros(max(need[1], 1), dtype=torch.int32, device=device))
        return ws

    def current(self, dev: int):
        """Device ``dev``'s buffers (None before its first use)."""
        return self._ws.get(dev)


def _covers(ws: Buffers, need: Need) -> bool:
    return ws[0].numel() >= need[0] and ws[1].numel() >= need[1]
