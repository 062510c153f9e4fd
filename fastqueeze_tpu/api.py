"""Stable one-call library API.

The CLI (`python -m fastqueeze_tpu.cli`) mirrors the reference binary;
this module is the supported entry point for programmatic use:

    from fastqueeze_tpu import api

    stats = api.compress("reads.fq", "out.fqz")                 # SE
    stats = api.compress(("r1.fq", "r2.fq"), "out.fqz")         # PE
    stats = api.compress("reads.fq", "out.fqz", reference="ref.fa")
    paths = api.decompress("out.fqz", "restored")               # bit-exact
    info  = api.describe("out.fqz")

Everything here delegates to the pipeline drivers (pipeline/driver.py,
pipeline/pe.py, pipeline/aligned.py); parameters are the same
`CodecParams` the CLI builds from its flags (reference SeqArc param
surface, SURVEY.md C2).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

from fastqueeze_tpu import enable_compile_cache
from fastqueeze_tpu.config import CodecParams

Inputs = Union[str, Sequence[str]]


def _params(params: Optional[CodecParams], **overrides) -> CodecParams:
    p = params if params is not None else CodecParams()
    for k, v in overrides.items():
        if v is not None:
            setattr(p, k, v)
    return p


def compress(inputs: Inputs, out_path: str, *,
             reference: Optional[str] = None,
             params: Optional[CodecParams] = None,
             threads: Optional[int] = None,
             lossy: Optional[float] = None,
             mesh: Optional[int] = None,
             self_ref: Optional[bool] = None,
             part: Optional[tuple] = None) -> Dict:
    """Compress FASTQ file(s) into a .fqz archive.

    inputs: one path (SE), a (r1, r2) pair (PE), or 3+ paths (multi-file
    archive, the reference's `-m`).  reference: FASTA path to align
    against (index built/cached automatically; the reference's
    `-c ref.fa` mode).  self_ref: self-referential alignment (the CLI's
    `-S`; SE or PE, mutually exclusive with `reference`).  part: (k, n)
    multi-host compression — this call owns blocks k, k+n, ... and
    writes a PARTIAL archive (the CLI's `--part K:N`; assemble with
    :func:`merge`).  Returns the driver's stats dict (raw/compressed
    bytes, ratio, blocks, ...).
    """
    enable_compile_cache()
    if part is not None:
        if not (0 <= part[0] < part[1] <= 0xFFFFFFFF):
            raise ValueError(
                f"part wants (k, n) with 0 <= k < n, got {part}")
        if part[1] == 1:
            part = None            # 1 part == a plain single-run archive
    p = _params(params, threads=threads, mesh_n=mesh)
    if lossy is not None:
        p.lossy_factor = lossy
    if self_ref:
        if reference is not None:
            raise ValueError("self_ref and reference are mutually "
                             "exclusive")
        p.self_align = 1
    paths = [inputs] if isinstance(inputs, str) else list(inputs)
    if reference is not None:
        from fastqueeze_tpu.pipeline.aligned import (
            compress_pe_aligned, compress_se_aligned)
        if len(paths) == 1:
            return compress_se_aligned(p, reference, paths[0], out_path,
                                       part=part)
        if len(paths) == 2:
            return compress_pe_aligned(p, reference, paths[0], paths[1],
                                       out_path, part=part)
        raise ValueError("aligned mode takes 1 (SE) or 2 (PE) inputs")
    if len(paths) == 1:
        from fastqueeze_tpu.pipeline.driver import compress_se
        return compress_se(p, paths[0], out_path, part=part)
    if len(paths) == 2:
        from fastqueeze_tpu.pipeline.pe import compress_pe
        return compress_pe(p, paths[0], paths[1], out_path, part=part)
    if part is not None:
        raise ValueError("part is not supported with multi-file archives")
    from fastqueeze_tpu.pipeline.driver import compress_multi
    return compress_multi(p, paths, out_path)


def merge(out_path: str, parts: Sequence[str], *,
          force: bool = True) -> Dict:
    """Assemble partial archives (compress(part=(k, n))) into the final
    archive — byte-identical to a single-run archive (the CLI's
    `--merge`; reference SeqArcFile::mergeFile parity)."""
    from fastqueeze_tpu.container.arcfile import merge_archives
    return merge_archives(out_path, list(parts), force=force)


def decompress(archive: str, out_prefix: str, *,
               reference: Optional[str] = None,
               force: bool = True,
               threads: Optional[int] = None) -> List[str]:
    """Restore the original FASTQ file(s) from an archive (bit-exact;
    verified against the stored MD5s).  Returns the written paths.
    Aligned archives need the same reference FASTA (checked by MD5)."""
    enable_compile_cache()
    from fastqueeze_tpu.pipeline.driver import decompress as _d
    kw = {"force": force}
    if threads is not None:
        kw["threads"] = threads
    if reference is not None:
        kw["ref"] = reference
    return _d(archive, out_prefix, **kw)


def extract(archive: str, start: int, count: int, out_prefix: str, *,
            reference: Optional[str] = None, force: bool = True
            ) -> List[str]:
    """Random-access extraction: decode only the blocks covering reads
    (SE) / pairs (PE) [start, start+count) — the CLI's `-X`."""
    enable_compile_cache()
    from fastqueeze_tpu.pipeline.driver import extract as _x
    kw = {"force": force}
    if reference is not None:
        kw["ref"] = reference
    return _x(archive, out_prefix, start, count, **kw)


def describe(archive: str) -> Dict:
    """Archive metadata: files, params, blocks, sizes (the CLI's -L)."""
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(archive) as r:
        p = r.params
        return {
            "kind": ("PE" if p.is_pe else
                     ("multi" if getattr(p, "multi", 0) else "SE")),
            "files": list(r.file_list),
            "blocks": len(r.blocks),
            "aligned": bool(p.aligned),
            "params": p,
            "model_bytes": len(r.model_blob) if r.model_blob else 0,
            "raw_bytes": sum(b.raw_len1 + b.raw_len2 for b in r.blocks),
            "payload_bytes": sum(b.payload_len for b in r.blocks),
            "archive_bytes": os.path.getsize(archive),
        }


def build_index(reference: str,
                params: Optional[CodecParams] = None) -> str:
    """Build (or refresh) the seed index for a reference FASTA; returns
    the index path.  compress(reference=...) calls this implicitly."""
    enable_compile_cache()
    from fastqueeze_tpu.align.index import build_index as _b
    return _b(reference, _params(params))
