"""Host staging of the pipelined `System`: its uploads and summary reads
without a host wait on the frame's own device work.

The JAX System gets both from the runtime: `jnp.asarray` of a host array
returns before the transfer lands, and `summary.copy_to_host_async()`
starts the read one frame ahead. Here they are made by hand:

- **Uploads.** Each frame's image and its per-frame inputs (the IMU batch,
  the biases and the frame interval, flattened) go up in one copy from a
  pinned host buffer with `non_blocking=True`. Two buffers alternate, and
  a buffer is written again only after the event of the copy that last
  read it.
- **Summary reads.** `fetch` starts the copy of a device summary into a
  pinned host buffer and records an event; `read` waits on that event and
  returns a numpy copy. A frame summary takes one of two alternating
  buffers, so the copy of frame k + 1 never lands in the buffer of frame
  k, which is read after it is issued; the deferred keyframe summary has a
  buffer of its own.

On the CPU the same calls read and write the tensors directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Fetch(NamedTuple):
    """A summary on its way to the host: the device tensor, the host
    tensor it is copied into and the event after the copy (None on the
    CPU, where `host` is the tensor itself)."""

    device: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


class PipeStaging:
    """The pipelined System's pinned buffers: two for uploads of up to
    `n_upload` float32 values, two for frame summaries and one for the
    keyframe summary, of up to `n_summary` values each."""

    def __init__(self, device: torch.device, n_upload: int,
                 n_summary: int = 19):
        self.device = device
        self.pinned = device.type == "cuda"
        self._turn = {"upload": 0, "frame": 0}
        if not self.pinned:
            return

        def pinned(n):
            return torch.empty((n,), dtype=torch.float32, pin_memory=True)

        self._upload = [pinned(n_upload) for _ in range(2)]
        self._upload_done: list = [None, None]
        self._summary = {"frame": [pinned(n_summary) for _ in range(2)],
                         "keyframe": [pinned(n_summary)]}

    def _next(self, kind: str, n: int) -> int:
        i = self._turn.get(kind, 0)
        self._turn[kind] = (i + 1) % n
        return i

    def upload(self, values: np.ndarray) -> torch.Tensor:
        """`values` (1-D float32) as a tensor on the device, enqueued with
        no host wait on the device."""
        if not self.pinned:
            return torch.tensor(values, dtype=torch.float32)
        i = self._next("upload", 2)
        if self._upload_done[i] is not None:
            self._upload_done[i].synchronize()
        buf = self._upload[i][:values.size]
        buf.numpy()[:] = values
        out = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._upload_done[i] = done
        return out

    def fetch(self, summary: torch.Tensor, kind: str = "frame") -> Fetch:
        """Start the copy of a 1-D float32 summary to the host; `kind` is
        "frame" or "keyframe"."""
        if not self.pinned:
            return Fetch(summary, summary, None)
        bufs = self._summary[kind]
        host = bufs[self._next(kind, len(bufs))][:summary.numel()]
        host.copy_(summary, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return Fetch(summary, host, done)

    @staticmethod
    def read(f: Fetch) -> np.ndarray:
        """The fetched summary, once its copy has landed, as a numpy copy
        (the host buffer is reused two fetches later)."""
        if f.event is not None:
            f.event.synchronize()
        return f.host.numpy().copy()
