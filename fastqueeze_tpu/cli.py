"""Command-line interface.

Capability parity with the reference CLI (SURVEY.md C1/C2, README.md:18-44):
    fastqueeze -i <ref.fa>                build reference index
    fastqueeze -c [ref.fa] -1 A.fq [-2 B.fq] -o out   compress
    fastqueeze -d [ref.fa] out.fqz [-o prefix]        decompress
Options mirror SeqArc's: -t threads, -l lossy factor, -I max insert,
-f force overwrite, -P pipe-out mode, -p output-to-input-dir.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import fastqueeze_tpu
from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.utils.log import error, info
from fastqueeze_tpu.utils.metrics import DebugInfo


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fastqueeze",
        description="accelerator-native FASTQ compressor (SeqArc-capability "
                    "rebuild)")
    ap.add_argument("-i", "--index", metavar="REF", help="build index for REF")
    ap.add_argument("-c", "--compress", action="store_true")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("pos", nargs="*", default=[],
                    help="[ref.fa] for -c; [ref.fa] archive for -d")
    ap.add_argument("-1", dest="in1", action="append",
                    help="input FASTQ (SE or PE1); repeat with -m")
    ap.add_argument("-2", dest="in2", help="input FASTQ (PE2)")
    ap.add_argument("-m", dest="multi", action="store_true",
                    help="multi-file archive: pass several -1 inputs")
    ap.add_argument("-L", "--list", dest="list_arc", metavar="ARCHIVE",
                    help="list archive contents (files, blocks, params)")
    ap.add_argument("-o", dest="out", help="output archive / prefix")
    ap.add_argument("-f", dest="force", action="store_true",
                    help="force overwrite")
    # flags that shape CodecParams default to None so "explicitly passed"
    # is detectable even when the value equals the built-in default (an
    # explicit flag must beat the fastqueeze.config developer file)
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="worker parallelism (blocks in flight; default 0)")
    ap.add_argument("-l", dest="lossy", type=float, default=None,
                    help="lossy quality factor (e.g. 1.15)")
    ap.add_argument("-I", dest="max_insr", type=int, default=None,
                    help="max insert size for PE alignment")
    ap.add_argument("-s", dest="shm", action="store_true",
                    help="share the index across processes (mmap; "
                         "reference parity: POSIX shm staging)")
    ap.add_argument("-n", dest="no_orderbin", action="store_true",
                    help="reference parity (disable order binning); reads "
                         "are never reordered here, so this is a no-op")
    ap.add_argument("-q", dest="bwa", action="store_true",
                    help="long-seed aligner backend (wide 44-bit seeds, "
                    "higher specificity — the BWA-SMEM mode analogue)")
    ap.add_argument("-S", dest="self_align", action="store_true",
                    help="self-referential alignment: code each block's "
                    "reads against its own unique unmapped reads (no FASTA "
                    "needed on either side; wins on high-coverage / "
                    "near-duplicate data)")
    ap.add_argument("-X", dest="extract", metavar="START:COUNT",
                    help="random-access decode: only reads (PE: pairs) "
                    "[START, START+COUNT) — touches just the covering "
                    "blocks")
    ap.add_argument("-P", dest="pipeout", type=int, default=0,
                    choices=[0, 1, 2, 3], help="pipe decompressed reads to "
                    "stdout: 1=SE/PE1 2=PE2 3=interleaved")
    ap.add_argument("-p", dest="indir", action="store_true",
                    help="write output next to input")
    ap.add_argument("-D", dest="dump_config", action="store_true",
                    help="write ./fastqueeze.config with current defaults")
    ap.add_argument("--block-mb", type=int, default=None,
                    help="block size in MB (default 50)")
    ap.add_argument("--slevel", type=int, default=None,
                    help="sequence context level (default 3)")
    ap.add_argument("--qlevel", type=int, default=None,
                    help="quality context level (default 2)")
    ap.add_argument("--part", metavar="K:N",
                    help="multi-host compress: this invocation owns blocks "
                    "K, K+N, ... (round-robin) of the input and writes a "
                    "PARTIAL archive; every host scans the whole input (for "
                    "the whole-input MD5 and the shared frozen model), so "
                    "merging the N parts reproduces the single-run archive "
                    "byte-for-byte")
    ap.add_argument("--merge", action="store_true",
                    help="assemble partial archives (--part) into one final "
                    "archive: fastqueeze --merge part*.fqz -o out.fqz")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="block-data-parallel over N devices of the mesh "
                    "(-1 = all).  Archives are byte-identical to -t 1; on "
                    "decode, 0/unset inherits the encoder's setting "
                    "(clamped to visible devices)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the JAX CPU backend (validation runs; "
                    "coding and alignment then run on the native host "
                    "code)")
    ap.add_argument("--stats", action="store_true", help="print debug tables")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a jax.profiler trace of the run to DIR "
                    "(view with TensorBoard / xprof)")
    return ap


def _list_archive(path: str) -> None:
    """showFileList parity (reference C11): archive contents summary."""
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(path) as r:
        p = r.params
        kind = ("PE" if p.is_pe else
                ("multi" if getattr(p, "multi", 0) else "SE"))
        if r.part is not None:
            kind += f" PARTIAL (part {r.part[0]} of {r.part[1]})"
        print(f"{path}: {kind} archive, {len(r.blocks)} block(s), "
              f"{len(r.file_list)} file(s)")
        print(f"  params: slevel={p.slevel} qlevel={p.qlevel} "
              f"block={p.block_size_mb}MB lossy={p.lossy_factor} "
              f"aligned={p.aligned}"
              + (f" ref_md5={p.ref_md5}" if p.aligned else ""))
        if r.model_blob is not None:
            print(f"  frozen model: {len(r.model_blob):,} B")
        for i, name in enumerate(r.file_list):
            raw = sum((b.raw_len2 if (p.is_pe and i == 1) else b.raw_len1)
                      for b in r.blocks
                      if p.is_pe or b.file_id == i or not getattr(p, "multi", 0))
            print(f"  [{i}] {name}  {raw:,} B plaintext")
        total_payload = sum(b.payload_len for b in r.blocks)
        total_raw = sum(b.raw_len1 + b.raw_len2 for b in r.blocks)
        print(f"  blocks: {total_raw:,} B -> {total_payload:,} B "
              f"({total_raw / max(total_payload, 1):.2f}x)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        # must land before any jax device query; jax.config wins over
        # whatever platform list the environment preselected
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    fastqueeze_tpu.enable_compile_cache()
    t_start = time.time()
    dbg = DebugInfo()
    prof = None
    if args.profile:
        # tracing parity (reference DebugInfo timers, SURVEY.md C18; here
        # a full device trace on top of the --stats tables)
        import jax
        prof = jax.profiler.trace(args.profile)
        prof.__enter__()
    try:
        if args.dump_config:
            path = CodecParams().dump_config_file()
            info(f"wrote {path}")
        elif args.index:
            from fastqueeze_tpu.align.index import build_index
            p = CodecParams()
            p.apply_config_file()
            if args.bwa and p.seed_len <= 15:
                p.seed_len = 22
            out = build_index(args.index, p)
            info(f"index written: {out}")
        elif args.list_arc:
            _list_archive(args.list_arc)
        elif args.merge:
            if not args.out or len(args.pos) < 1:
                error("--merge needs part archives + -o out.fqz")
                return 2
            from fastqueeze_tpu.container.arcfile import merge_archives
            stats = merge_archives(args.out, args.pos, force=args.force)
            info(f"merged {stats['parts']} parts -> {args.out} "
                 f"({stats['blocks']} blocks, {stats['compressed']:,} B)")
        elif args.compress:
            if not args.in1:
                error("compress needs -1 <input.fq>")
                return 2
            in1 = args.in1[0]
            out = args.out or (os.path.splitext(in1)[0])
            if not out.endswith(".fqz"):
                out += ".fqz"
            if args.indir:
                out = os.path.join(os.path.dirname(os.path.abspath(in1)),
                                   os.path.basename(out))
            if os.path.exists(out) and not args.force:
                error(f"{out} exists (use -f to overwrite)")
                return 2
            ref = args.pos[0] if args.pos else None
            p = CodecParams(is_pe=1 if args.in2 else 0)
            p.apply_config_file()      # developer config (seqarc.config)
            for attr, val in (
                    ("block_size_mb", args.block_mb),
                    ("slevel", args.slevel),
                    ("qlevel", args.qlevel),
                    ("lossy_factor", args.lossy),
                    ("max_insr", args.max_insr),
                    ("threads", args.threads),
                    ("mesh_n", args.mesh)):
                if val is not None:    # explicit CLI flag beats config file
                    setattr(p, attr, val)
            if args.bwa:
                if p.seed_len <= 15:
                    p.seed_len = 22    # -q: long-seed backend
                if p.max_indel == 0:
                    p.max_indel = 3    # -q: indel-capable (BWA-path parity)
            part = None
            if args.part:
                k, _, n = args.part.partition(":")
                try:
                    part = (int(k), int(n))
                except ValueError:
                    error("--part wants K:N (e.g. --part 0:4)")
                    return 2
                if not (0 <= part[0] < part[1]):
                    error(f"--part {args.part}: need 0 <= K < N")
                    return 2
                if part[1] == 1:
                    part = None    # 1 part == a plain single-run archive
            if args.shm:
                p.shm_index = 1
            if args.self_align:
                if ref or args.multi:
                    error("-S is reference-free (no ref.fa / -m)")
                    return 2
                p.self_align = 1
            if args.multi:
                if args.in2 or ref:
                    error("-m supports plain SE inputs (no -2 / reference)")
                    return 2
                if part:
                    error("--part is not supported with -m")
                    return 2
                from fastqueeze_tpu.pipeline.driver import compress_multi
                stats = compress_multi(p, args.in1, out, dbg=dbg)
            elif args.in2:
                from fastqueeze_tpu.pipeline.pe import compress_pe
                stats = compress_pe(p, in1, args.in2, out,
                                    ref=ref, dbg=dbg, part=part)
            else:
                if ref:
                    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
                    stats = compress_se_aligned(p, ref, in1, out,
                                                dbg=dbg, part=part)
                else:
                    from fastqueeze_tpu.pipeline.driver import compress_se
                    stats = compress_se(p, in1, out, dbg=dbg, part=part)
            info(f"compressed {stats['raw']:,} -> {stats['compressed']:,} B "
                 f"(ratio {stats['ratio']:.2f}x) in {stats['blocks']} blocks")
        elif args.decompress:
            if args.part:
                error("--part applies to compression only")
                return 2
            if len(args.pos) == 2:
                ref, arc = args.pos
            elif len(args.pos) == 1:
                ref, arc = None, args.pos[0]
            else:
                error("decompress needs an archive path")
                return 2
            if args.extract:
                from fastqueeze_tpu.pipeline.driver import extract
                s, _, c = args.extract.partition(":")
                outs = extract(arc, args.out, int(s), int(c or 1),
                               ref=ref, force=args.force, dbg=dbg)
            else:
                from fastqueeze_tpu.pipeline.driver import decompress
                # -t 0 (default) inherits the archive's encode-side
                # thread count; an explicit -t N overrides it
                outs = decompress(arc, args.out, dbg=dbg, ref=ref,
                                  pipeout=args.pipeout, force=args.force,
                                  indir=args.indir,
                                  threads=args.threads or 0,
                                  mesh=args.mesh or 0)
            if outs:
                info("wrote: " + ", ".join(outs))
        else:
            build_parser().print_help()
            return 1
    except (ValueError, FileNotFoundError, EOFError) as e:
        error(str(e))
        return 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            info(f"profiler trace written to {args.profile}")
    if args.stats:
        dbg.print()
    info(f"total time {time.time() - t_start:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
