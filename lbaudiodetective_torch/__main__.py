"""Command-line interface: ``python -m lbaudiodetective_torch <cmd> ...``.

The JAX package's CLI on one torch device (``--device``, default ``cuda``;
it raises when CUDA is absent, it never falls back to the CPU):

  fingerprint <clip>                      print the fingerprint string form
  compare <clip1> <clip2> [--algorithm maa]  print the match score (count)
  enroll <dir> -o lib.npz                 build a library from a directory
  identify <clip> --library lib.npz       best match + per-track scores
  serve --library lib.npz                 run the HTTP identification edge
  client <clip> --url http://host:8414    POST a clip to a running server
  listen <clip> --url http://host:8414    stream a clip's fingerprint to one
  dedup --library lib.npz [--devices N]   all-pairs near-duplicate scan

``dedup --devices N`` runs the ring over N slots (N cards on CUDA, as the
reference needs N devices; N slots with ``--device cpu``), and
``serve --shard-library N`` serves the library split N ways over the mesh.

Audio: CAF (IMA4/LPCM), WAV, and AIFF/AIFF-C.  Library files are the JAX
package's npz format (parameter-hash guarded); either package reads the
other's.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _detective(device: str):
    from lbaudiodetective_torch.models.detective import AudioDetective

    return AudioDetective(device=device)


def _audio_files(directory: str) -> list[pathlib.Path]:
    exts = {".caf", ".wav", ".aiff", ".aif", ".aifc", ".au", ".snd"}
    return sorted(p for p in pathlib.Path(directory).iterdir()
                  if p.suffix.lower() in exts)


def cmd_fingerprint(args) -> int:
    print(_detective(args.device).process_audio_file(args.clip).to_string())
    return 0


def cmd_compare(args) -> int:
    if args.algorithm == "maa":
        # The essay's rejected predecessor: a match count, not a score.
        from lbaudiodetective_torch.models.maa import maa_compare_audio_files

        print(maa_compare_audio_files(args.clip1, args.clip2, device=args.device))
        return 0
    score = _detective(args.device).compare_audio_files(args.clip1, args.clip2)
    print(f"{score:.4f}")
    return 0


def cmd_enroll(args) -> int:
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    files = _audio_files(args.directory)
    if not files:
        print(f"no audio files in {args.directory}", file=sys.stderr)
        return 2
    det = _detective(args.device)
    fps = det.process_batch([str(f) for f in files])  # one padded dispatch
    names = [f.stem for f in files]
    for f, fp in zip(files, fps):
        print(f"enrolled {f.stem}: {fp.num_subfingerprints} subfingerprints",
              file=sys.stderr)
    # np.savez appends '.npz' when missing: normalise first so the .names.json
    # sidecar sits next to the file actually written.
    out_path = args.output if args.output.endswith(".npz") else args.output + ".npz"
    names_path = pathlib.Path(out_path).with_suffix(".names.json")
    if args.append and pathlib.Path(out_path).exists():
        # The parameter-hash guard refuses libraries from other configs.
        lib = FingerprintLibrary.load(out_path, det.config, args.device).extend(fps)
        old_names = (json.loads(names_path.read_text())
                     if names_path.exists()
                     else [f"track_{i}" for i in range(len(lib) - len(fps))])
        names = old_names + names
    else:
        lib = FingerprintLibrary.from_fingerprints(fps, det.config, args.device)
    lib.save(out_path)
    names_path.write_text(json.dumps(names))
    print(f"wrote {out_path} ({len(lib)} tracks)", file=sys.stderr)
    return 0


def _load_library(path: str, device: str):
    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    # Passing the config arms the parameter-hash guard: a library enrolled
    # under different parameters refuses to load.
    lib = FingerprintLibrary.load(path, FingerprintConfig(), device)
    names_file = pathlib.Path(path).with_suffix(".names.json")
    if names_file.exists():
        names = json.loads(names_file.read_text())
        if len(names) != len(lib):
            raise SystemExit(
                f"{names_file} has {len(names)} names for {len(lib)} tracks"
                " — stale sidecar?")
    else:
        names = [f"track_{i}" for i in range(len(lib))]
    return lib, names


def cmd_identify(args) -> int:
    if args.top_k < 0:
        print("--top-k must be non-negative", file=sys.stderr)
        return 2
    lib, names = _load_library(args.library, args.device)
    fp = _detective(args.device).process_audio_file(args.clip)
    if args.top_k:
        idx, sc = lib.search(fp, top_k=args.top_k)
        out = {"track": names[int(idx[0])], "score": round(float(sc[0]), 4),
               "top": [{"track": names[int(i)], "score": round(float(s), 4)}
                       for i, s in zip(idx, sc)]}
        print(json.dumps(out))
        return 0
    scores = lib.match(fp)
    best = int(scores.argmax())
    out = {"track": names[best], "score": round(float(scores[best]), 4)}
    if args.all_scores:
        out["scores"] = {n: round(float(s), 4) for n, s in zip(names, scores)}
    print(json.dumps(out))
    return 0


def _mesh(n_slots: int, library_parallelism: int, device: str):
    """The ``(data, library)`` mesh of a sharded command: every visible card
    on CUDA (``n_slots`` of them where given), ``n_slots`` slots on the
    CPU."""
    from lbaudiodetective_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices=n_slots or None, library_parallelism=library_parallelism,
                     device=device)


def cmd_dedup(args) -> int:
    """All-pairs near-duplicate scan of an enrolled library: the packed ring
    dedup (``parallel.sharded_packed.ring_dedup_topk_packed``, BASELINE
    config 5's candidate exchange) over a ``--devices``-way ring (1 =
    plain all-pairs), printing each track's top-k candidates, optionally
    filtered by ``--threshold``."""
    from lbaudiodetective_torch.parallel.mesh import unshard
    from lbaudiodetective_torch.parallel.sharded_packed import ring_dedup_topk_packed

    if args.top_k < 1:
        print("--top-k must be >= 1", file=sys.stderr)
        return 2
    if args.devices < 1:
        print("--devices must be >= 1", file=sys.stderr)
        return 2
    lib, names = _load_library(args.library, args.device)
    l_real = len(lib)
    if l_real < 2:
        print("library has fewer than 2 tracks — nothing to dedup", file=sys.stderr)
        return 2
    mesh = _mesh(args.devices, args.devices, args.device)
    pad = (-l_real) % mesh.shape["library"]
    # Padded entries score 0.0 in the top-k: ask for `pad` extra slots so
    # they never displace a real candidate, then drop them.
    k = min(args.top_k, l_real - 1)
    scores, idx = ring_dedup_topk_packed(
        lib.pos_words, lib.neg_words, lib.counts, lib.pairs, mesh,
        k=min(k + pad, l_real + pad - 1),
        subfingerprint_length=lib.config.subfingerprint_length)
    scores = unshard(scores).cpu().numpy()[:l_real]
    idx = unshard(idx).cpu().numpy()[:l_real]
    out = []
    for t in range(l_real):
        cands = [{"track": names[int(j)], "score": round(float(s), 4)}
                 for s, j in zip(scores[t], idx[t])
                 if 0 <= int(j) < l_real and float(s) >= args.threshold][:k]
        if cands:
            out.append({"track": names[t], "candidates": cands})
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0


def cmd_serve(args) -> int:
    from lbaudiodetective_torch.serving import IdentificationService, serve_forever

    lib, names = _load_library(args.library, args.device)
    shard_note = ""
    if args.shard_library:
        from lbaudiodetective_torch.parallel.sharded_library import ShardedFingerprintLibrary

        on_cpu = args.device.startswith("cpu")
        mesh = _mesh(args.shard_library if on_cpu else 0, args.shard_library, args.device)
        lib = ShardedFingerprintLibrary(lib, mesh)
        shard_note = f", {mesh.shape['library']}-way library-sharded"
    service = IdentificationService(
        lib, names, batch_window_s=args.batch_window, max_batch=args.max_batch,
        n_sub_cap=args.n_sub_cap, search_threshold=args.search_threshold,
        top_k=args.top_k, stream_pool=args.stream_pool,
        stream_flush_window_s=args.stream_flush_window, device=args.device)
    if args.sessions_dir and pathlib.Path(args.sessions_dir).is_dir():
        n = service.load_sessions(args.sessions_dir)
        if n:
            print(f"restored {n} live session(s) from {args.sessions_dir}",
                  file=sys.stderr)
    print(f"serving {len(names)} tracks on {args.host}:{args.port} ({service.device}"
          f"{shard_note})", file=sys.stderr)
    try:
        serve_forever(service, host=args.host, port=args.port)
    finally:
        # Checkpoint live sessions on shutdown (Ctrl-C included) so the next
        # boot with the same --sessions-dir resumes them.
        if args.sessions_dir:
            n = service.save_sessions(args.sessions_dir)
            print(f"saved {n} live session(s) to {args.sessions_dir}", file=sys.stderr)
    return 0


def cmd_client(args) -> int:
    """The essay's app side (PDF §3.2.4-3.2.5): upload a recording (or,
    with ``--local-extract``, its fingerprint) and print the answer."""
    import urllib.error
    import urllib.request

    if args.local_extract:
        fp = _detective(args.device).process_audio_file(args.clip)
        payload = fp.to_string().encode("ascii")
        url = args.url.rstrip("/") + "/identify-fingerprint"
    else:
        with open(args.clip, "rb") as f:
            payload = f.read()
        url = args.url.rstrip("/") + ("/fingerprint" if args.fingerprint else "/identify")
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=payload),
                                    timeout=args.timeout) as r:
            print(r.read().decode())
        return 0
    except urllib.error.HTTPError as e:
        print(e.read().decode(), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 2


def cmd_listen(args) -> int:
    """Live recognition against a running server: fingerprint the clip
    here, post it to ``/stream/<id>`` ``--chunk`` subfingerprints at a time,
    and print the running best match after every post."""
    import urllib.error
    import urllib.request

    def post(path, payload=b""):
        req = urllib.request.Request(args.url.rstrip("/") + path, data=payload)
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            return json.loads(r.read().decode())

    fp = _detective(args.device).process_audio_file(args.clip)
    subs = fp.to_string().split("+") if fp.num_subfingerprints else []
    try:
        sid = post("/stream/open")["session"]
        for i in range(0, len(subs), args.chunk):
            body = post(f"/stream/{sid}", "+".join(subs[i:i + args.chunk]).encode("ascii"))
            print(f"[{body['n']:4d} subs] {body['track']} {body['score']:.4f}",
                  file=sys.stderr)
        print(json.dumps(post(f"/stream/{sid}/close")))
        return 0
    except urllib.error.HTTPError as e:
        print(e.read().decode(), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lbaudiodetective_torch",
                                description=__doc__.split("\n", 1)[0])
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device (default cuda; raises without CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fingerprint", parents=[dev],
                       help="print a clip's fingerprint string")
    f.add_argument("clip")
    f.set_defaults(fn=cmd_fingerprint)

    c = sub.add_parser("compare", parents=[dev], help="match score between two clips")
    c.add_argument("clip1")
    c.add_argument("clip2")
    c.add_argument("--algorithm", choices=("afa", "maa"), default="afa",
                   help="afa = the shipped fingerprinting algorithm; "
                        "maa = the essay's rejected predecessor "
                        "(prints a match count, not a score)")
    c.set_defaults(fn=cmd_compare)

    e = sub.add_parser("enroll", parents=[dev], help="build a library from a directory")
    e.add_argument("directory")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("--append", action="store_true",
                   help="add to an existing library instead of overwriting")
    e.set_defaults(fn=cmd_enroll)

    i = sub.add_parser("identify", parents=[dev],
                       help="identify a clip against a library")
    i.add_argument("clip")
    i.add_argument("--library", required=True)
    i.add_argument("--all-scores", action="store_true")
    i.add_argument("--top-k", type=int, default=0, metavar="K",
                   help="answer with the exact top-K via two-stage "
                        "coarse->exact search (large libraries)")
    i.set_defaults(fn=cmd_identify)

    d = sub.add_parser("dedup", parents=[dev],
                       help="all-pairs near-duplicate scan of a library (packed ring dedup)")
    d.add_argument("--library", required=True)
    d.add_argument("--top-k", type=int, default=3, metavar="K",
                   help="candidates reported per track (default 3)")
    d.add_argument("--threshold", type=float, default=0.0,
                   help="only report candidate pairs scoring >= this")
    d.add_argument("--devices", type=int, default=1, metavar="N",
                   help="ring size: shard the library over N cards (N slots on the CPU)")
    d.add_argument("--compact", action="store_true", help="single-line JSON output")
    d.set_defaults(fn=cmd_dedup)

    s = sub.add_parser("serve", parents=[dev], help="run the HTTP identification server")
    s.add_argument("--library", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8414)
    s.add_argument("--shard-library", type=int, default=0, metavar="N",
                   help="shard the library N-way over the mesh of every visible card "
                        "(N slots with --device cpu; 0 = one device)")
    s.add_argument("--batch-window", type=float, default=0.0, metavar="S",
                   help="micro-batch concurrent identifies arriving within "
                        "S seconds into one device dispatch (0 = off)")
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--n-sub-cap", type=int, default=0, metavar="K",
                   help="pin batched extraction to one shape (cap each clip "
                        "at K subfingerprints)")
    s.add_argument("--search-threshold", type=int, default=4096,
                   help="library size above which responses use two-stage "
                        "top-k search instead of full score enumeration")
    s.add_argument("--top-k", type=int, default=5)
    s.add_argument("--sessions-dir", default="", metavar="DIR",
                   help="persist live-recognition sessions here on shutdown "
                        "and restore them on boot (same library required)")
    s.add_argument("--stream-pool", action="store_true",
                   help="pool live-recognition sessions in one slot-batched "
                        "matcher: concurrent posts fold into one call per "
                        "flush window")
    s.add_argument("--stream-flush-window", type=float, default=0.02,
                   metavar="S", help="pooled-session flush window seconds")
    s.set_defaults(fn=cmd_serve)

    cl = sub.add_parser("client", parents=[dev], help="POST a clip to a running server")
    cl.add_argument("clip")
    cl.add_argument("--url", default="http://127.0.0.1:8414")
    cl.add_argument("--fingerprint", action="store_true",
                    help="request /fingerprint instead of /identify")
    cl.add_argument("--local-extract", action="store_true",
                    help="fingerprint here (on --device) and upload only the "
                         "fingerprint string (the essay's phone-side protocol)")
    cl.add_argument("--timeout", type=float, default=120.0)
    cl.set_defaults(fn=cmd_client)

    li = sub.add_parser("listen", parents=[dev],
                        help="stream a clip's fingerprint to a running server "
                             "in increments (live recognition)")
    li.add_argument("clip")
    li.add_argument("--url", default="http://127.0.0.1:8414")
    li.add_argument("--chunk", type=int, default=4, metavar="K",
                    help="subfingerprints per post")
    li.add_argument("--timeout", type=float, default=120.0)
    li.set_defaults(fn=cmd_listen)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
