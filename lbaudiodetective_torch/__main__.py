"""Command-line interface: ``python -m lbaudiodetective_torch <cmd> ...``.

The offline enroll-then-identify workflow of the JAX package's CLI, on one
torch device (``--device``, default ``cuda``; it raises when CUDA is
absent, it never falls back to the CPU):

  fingerprint <clip>                      print the fingerprint string form
  compare <clip1> <clip2>                 print the match score
  enroll <dir> -o lib.npz                 build a library from a directory
  identify <clip> --library lib.npz       best match + per-track scores

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
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
