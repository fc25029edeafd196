"""Dataset housekeeping: lzma compression and pickle integrity checks.

Equivalents of ``max/ds_download/eagle_compress.py:7-19`` and
``max/ds_download/ds_integrity_test.py:1-14``; a copy of
``fluid_llm_tpu/tools/dataset_io.py`` (the same bytes out).

    python -m fluid_llm_tpu_torch.tools.dataset_io compress|decompress|check <path>
"""

from __future__ import annotations

import argparse
import lzma
import os
import pickle
import sys


def compress_file(path: str, remove_original: bool = False) -> str:
    out = path + ".xz"
    with open(path, "rb") as f_in, lzma.open(out, "wb") as f_out:
        f_out.write(f_in.read())
    if remove_original:
        os.remove(path)
    return out


def decompress_file(path: str) -> str:
    assert path.endswith(".xz")
    out = path[:-3]
    with lzma.open(path, "rb") as f_in, open(out, "wb") as f_out:
        f_out.write(f_in.read())
    return out


def compress_dir(path: str, suffix: str = ".pkl", remove_original: bool = False) -> list[str]:
    done = []
    for root, _, files in os.walk(path):
        for fname in sorted(files):
            if fname.endswith(suffix):
                done.append(compress_file(os.path.join(root, fname), remove_original))
    return done


def integrity_check(path: str, suffix: str = ".pkl") -> list[str]:
    """Try-unpickle every file; return the corrupt ones."""
    bad = []
    for root, _, files in os.walk(path):
        for fname in sorted(files):
            if not fname.endswith(suffix):
                continue
            fp = os.path.join(root, fname)
            try:
                with open(fp, "rb") as f:
                    pickle.load(f)
            except Exception as e:
                print(f"CORRUPT: {fp}: {e}")
                bad.append(fp)
    return bad


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("command", choices=["compress", "decompress", "check"])
    parser.add_argument("path")
    parser.add_argument("--remove_original", action="store_true")
    args = parser.parse_args(argv)
    if args.command == "compress":
        for p in compress_dir(args.path, remove_original=args.remove_original):
            print("compressed", p)
    elif args.command == "decompress":
        print(decompress_file(args.path))
    else:
        bad = integrity_check(args.path)
        print(f"{len(bad)} corrupt files")


if __name__ == "__main__":
    main(sys.argv[1:])
