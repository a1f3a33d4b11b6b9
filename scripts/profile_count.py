"""Time the phases of the device k-mer count on the accelerator.

    python scripts/profile_count.py [--glen 4600000] [--pairs 550000]
        [--trace DIR]

Generates the north-star reads (scripts/make_synth_fastq.py shape,
seed 42) in a temporary directory, then times, each after a warm-up
call and ending in block_until_ready:
  * kmerize_chunk on one 65,536 x 250 chunk at k=60, and over all chunks;
  * the whole-stream lax.sort at k=60 (4 key planes, context in the pad
    bits) and collapse_planes on its output;
  * the K=260 stream of genome tiles (W=17): _sort_big_w and
    collapse_planes;
  * count_kmers_device (k=60) and count_kmers_flat (K=260) end to end.
--trace DIR also writes a jax.profiler trace of one count_kmers_device
call and prints the device time of its ten largest operations.
Prints one line per measurement with the card's name and power limit.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timeit(fn, reps=3):
    import jax

    jax.block_until_ready(fn())  # warm-up: compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def top_device_ops(trace_dir, n=10):
    """Device time per operation name, summed over a trace's GPU planes."""
    import glob

    import jax

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    tot = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
    busy = sum(tot.values())
    for name, ns in sorted(tot.items(), key=lambda x: -x[1])[:n]:
        print(f"  {ns / 1e6:9.2f} ms  {100 * ns / busy:5.1f}%  {name[:90]}")
    print(f"  {busy / 1e6:9.2f} ms  device time summed over all operations")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glen", type=int, default=4_600_000)
    ap.add_argument("--pairs", type=int, default=550_000)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax

    from w2rap_contigger_tpu.backend import use_compile_cache

    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    print(f"card: {card}; jax: {dev.platform} {dev.device_kind}")

    work = tempfile.mkdtemp(prefix="w2rap_profile_")
    try:
        profile(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def profile(args, work):
    import jax
    import jax.numpy as jnp

    from w2rap_contigger_tpu.core import dna
    from w2rap_contigger_tpu.core.io_fastq import extract_reads
    from w2rap_contigger_tpu.ops import kmer_engine as ke

    subprocess.run([
        sys.executable, "scripts/make_synth_fastq.py", work,
        "--glen", str(args.glen), "--pairs", str(args.pairs),
        "--rlen", "250", "--insert", "500", "--seed", "42",
    ], check=True, cwd=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    reads = extract_reads(f"{work}/reads_R1.fastq,{work}/reads_R2.fastq")
    b, ln, q = reads.bases, reads.lengths, reads.quals
    n, L = b.shape
    k, W, C = 60, 4, 65536

    cb, cl, cq = (jnp.asarray(x[:C]) for x in (b, ln, q))
    t = timeit(lambda: ke.kmerize_chunk(cb, cl, cq, k, 7))
    n_chunks = -(-n // C)
    print(f"kmerize_chunk {C}x{L} k={k}: {t * 1e3:.2f} ms/chunk, "
          f"{n_chunks} chunks ~ {t * n_chunks * 1e3:.1f} ms")

    # the k=60 stream as count_kmers_device builds it
    word_parts = [[] for _ in range(W)]
    pay_parts = []
    for s in range(0, n, C):
        sl = slice(s, min(s + C, n))
        words, ctx, _ = ke.kmerize_chunk(
            jnp.asarray(b[sl]), jnp.asarray(ln[sl]), jnp.asarray(q[sl]), k, 7)
        wout, pay = ke._payload_mask_jit(words, ctx, W, 0, 0)
        for j in range(W):
            word_parts[j].append(wout[j])
        pay_parts.append(pay)
    n_rows = sum(p.shape[0] for p in pay_parts)
    n_pad = ke._quantize_octave(n_rows, 4096)
    pad_bits = 2 * (16 * W - k)
    planes = [ke._concat_pad(word_parts[j], n_pad, ke.FULL)
              for j in range(W - 1)]
    pay = ke._concat_pad(pay_parts, n_pad, np.uint32(0))
    planes.append(ke._concat_pad(word_parts[W - 1], n_pad, ke.FULL)
                  | ((pay >> np.uint32(8)) & np.uint32(0xFF)))
    planes = jax.block_until_ready(planes)
    sort4 = jax.jit(lambda ps: jax.lax.sort(ps, num_keys=W))
    t = timeit(lambda: sort4(planes))
    gb = n_pad * 4 * W * 2 / 1e9
    print(f"lax.sort k={k}: {n_pad} rows x {W} planes: {t * 1e3:.1f} ms "
          f"({gb / t:.1f} GB/s of one read + one write)")
    sp = sort4(planes)
    words = list(sp[: W - 1]) + [sp[W - 1] & ~np.uint32(0xFF)]
    spay = (sp[W - 1] & np.uint32(0xFF)) << np.uint32(8) | np.uint32(1)
    spay = jnp.where(planes[0] == ke.FULL, 0, spay)  # sentinel tail
    t = timeit(lambda: ke._collapse_planes_jit(words, spay, min_freq=4))
    print(f"collapse_planes k={k}: {n_pad} rows: {t * 1e3:.1f} ms")
    t = timeit(lambda: ke._sort_collapse_small_w(
        tuple(tuple(p) for p in word_parts), tuple(pay_parts), W, n_pad,
        pad_bits, 4))
    print(f"sort+collapse (one executable) k={k}: {t * 1e3:.1f} ms")
    del planes, sp, words, spay, word_parts, pay_parts

    t = timeit(lambda: ke.count_kmers_device(b, ln, q, k)[0].dev["words"],
               reps=2)
    print(f"count_kmers_device k={k} {n} reads: {t:.3f} s")
    if args.trace:
        jax.profiler.start_trace(args.trace)
        jax.block_until_ready(ke.count_kmers_device(b, ln, q, k)[0].dev["words"])
        jax.profiler.stop_trace()
        print("count_kmers_device trace, largest device operations:")
        top_device_ops(args.trace)

    # K=260: overlapping 1000 bp genome tiles every 250 bp
    with open(f"{work}/genome.fasta") as f:
        g = dna.seq_to_codes("".join(l.strip() for l in f if l[0] != ">"))
    K, W2 = 260, 17
    starts = np.arange(0, len(g) - 1000 + 1, 250)
    flat = g[starts[:, None] + np.arange(1000)[None, :]].reshape(-1)
    T = len(flat)
    valid = np.ones(T, bool)
    pos = np.arange(T)
    valid = (pos % 1000) <= 1000 - K
    wd, cd, vd = ke.kmerize_flat_chunk(
        jnp.asarray(np.concatenate([flat, np.zeros(272, np.uint8)])),
        jnp.asarray(valid), jnp.asarray(valid & (pos % 1000 > 0)),
        jnp.asarray(valid & (pos % 1000 < 1000 - K)),
        jnp.asarray(flat[np.maximum(pos - 1, 0)]),
        jnp.asarray(flat[np.minimum(pos + K, T - 1)]), K)
    wout, pay = ke._payload_mask_jit(wd, cd, W2, 0, 0)
    n_pad = ke._quantize_octave(T, 4096)
    planes = [ke._concat_pad([wout[j]], n_pad, ke.FULL) for j in range(W2)]
    pay = ke._concat_pad([pay], n_pad, np.uint32(0))
    big = jax.jit(lambda ps, p: ke._sort_big_w(ps, p, W2))
    t = timeit(lambda: big(planes, pay))
    print(f"_sort_big_w K={K}: {n_pad} rows x {W2} planes: {t * 1e3:.1f} ms")
    sp, tie = big(planes, pay)
    t = timeit(lambda: ke._collapse_planes_jit(sp[:W2], sp[W2], min_freq=1))
    print(f"collapse_planes K={K}: {n_pad} rows: {t * 1e3:.1f} ms "
          f"(tie flag {bool(tie)})")
    seg = np.arange(len(starts) + 1, dtype=np.int64) * 1000
    t = timeit(lambda: ke.count_kmers_flat(
        flat, seg, K, force_device=True).dev["words"], reps=2)
    print(f"count_kmers_flat K={K} {len(starts)} segments: {t:.3f} s")


if __name__ == "__main__":
    main()
