"""Field-descriptor generator, the counterpart of the reference's
``jindo-modulus`` codegen CLI (reference jindo-modulus/main.go).

The limb engine reads a *descriptor*, so "codegen" is a modulus search and
its constants:

    python3 -m ringo_tpu_torch.fields.modulus -n 128          # ~128-bit modulus
    python3 -m ringo_tpu_torch.fields.modulus -b 60272 -k 16  # explicit b, k

Prints a JSON descriptor (p, b, k, limb count, Montgomery constants) that
``FieldSpec`` reconstructs exactly; ``--python`` prints a FieldSpec literal
instead.  Output equal to ``ringo_tpu.fields.modulus``'s.
"""

from __future__ import annotations

import argparse
import json
import sys

from .spec import DIGIT_BITS, FieldSpec, find_modulus, is_probable_prime


def describe(spec: FieldSpec) -> dict:
    return {
        "p": str(spec.p),
        "b": spec.b,
        "k": spec.k,
        "bits": spec.bits,
        "limbs_16bit": spec.w,
        "montgomery_radix_log2": DIGIT_BITS * spec.w,
        "r_mod_p": str(spec.r_mod_p),
        "r2_mod_p": str(spec.r2_mod_p),
        "qinv16": spec.qinv16,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m ringo_tpu_torch.fields.modulus",
        description="Search for a Jindo-friendly modulus p = b^k + 1 and "
                    "emit its field descriptor (replaces jindo-modulus).")
    ap.add_argument("-n", "--bits", type=int,
                    help="target bit size (search window [n, 2n))")
    ap.add_argument("-b", "--base", type=int, help="explicit base b")
    ap.add_argument("-k", "--exp", type=int, help="explicit exponent k")
    ap.add_argument("--python", action="store_true",
                    help="emit a FieldSpec literal instead of JSON")
    args = ap.parse_args(argv)

    if args.base is not None and args.exp is not None:
        k = args.exp
        if k & (k - 1) or k < 2:
            print("error: k must be a power of two >= 2", file=sys.stderr)
            return 1
        p = args.base ** k + 1
        if not is_probable_prime(p):
            print(f"error: {args.base}^{k}+1 is not prime", file=sys.stderr)
            return 1
        spec = FieldSpec(p=p, b=args.base, k=k)
    elif args.bits is not None:
        spec = find_modulus(args.bits, 2 * args.bits)
    else:
        ap.print_help()
        return 1

    if args.python:
        print(f"FieldSpec(p={spec.b}**{spec.k} + 1, b={spec.b}, k={spec.k})"
              f"  # {spec.bits} bits, {spec.w} limbs")
    else:
        print(json.dumps(describe(spec), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
