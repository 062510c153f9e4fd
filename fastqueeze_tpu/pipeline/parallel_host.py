"""Host-side block pipelining (reference C5/C6 parity: SeqArcRead reader
thread + ReadBufPool bounded queue + N encode/decode worker threads,
srcfile:SeqArcRead.cpp/BufPool.cpp).

The rebuild keeps one device stream but overlaps the host stages
(parse / MD5 / ID binning / host range coding / device transfers) of
several blocks: a thread pool runs the per-block stage function while the
main thread consumes results strictly in block order.  In-flight blocks are
bounded (reference: bufnum = 2*threads - 1)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def block_dp_devices(params):
    """Resolve the block-DP device set from ``params.mesh_n`` and widen the
    host pipeline so every in-flight device has a feeding thread.  Returns
    None when no mesh is requested (plain host threading)."""
    if not params.mesh_n:
        return None
    from fastqueeze_tpu.parallel.mesh import block_devices
    devices = block_devices(params.mesh_n)
    if devices and params.threads < len(devices):
        params.threads = len(devices)
    return devices


def device_parallel(items: Iterable[T], fn: Callable[[int, T], R],
                    devices, workers: int) -> Iterator[Tuple[int, R]]:
    """``ordered_parallel`` with ``fn`` round-robined over ``devices``
    (block-DP: whole blocks per device; payloads stay byte-identical to the
    single-device run).  ``devices=None`` degrades to plain host threads."""
    if devices:
        from fastqueeze_tpu.parallel.mesh import device_cycled
        fn = device_cycled(devices, fn)
    return ordered_parallel(items, fn, max(1, workers))


def ordered_parallel(items: Iterable[T], fn: Callable[[int, T], R],
                     workers: int) -> Iterator[Tuple[int, R]]:
    """Run ``fn(idx, item)`` over items with ``workers`` threads, yielding
    results in submission order with at most ``2*workers - 1`` in flight."""
    if workers <= 1:
        for i, item in enumerate(items):
            yield i, fn(i, item)
        return
    max_inflight = 2 * workers - 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        it = enumerate(items)
        done = False
        while True:
            while not done and len(pending) < max_inflight:
                try:
                    i, item = next(it)
                except StopIteration:
                    done = True
                    break
                pending.append((i, pool.submit(fn, i, item)))
            if not pending:
                return
            i, fut = pending.pop(0)
            yield i, fut.result()
