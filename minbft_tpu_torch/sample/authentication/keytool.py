"""keytool — generate testnet keystores from the command line (port of
:mod:`minbft_tpu.sample.authentication.keytool`).

Reference: the cobra/viper ``keytool generate`` command
(sample/authentication/keytool/cmd/generate.go:44-142) writes a keys.yaml
with replica/usig/client sections.  Usage:

    python -m minbft_tpu_torch.sample.authentication.keytool generate \
        -o keys.yaml -n 3 --clients 1 --scheme ecdsa-p256 --usig auto

Flags fall back to ``KEYTOOL_*`` environment variables (the viper env
binding equivalent, reference keytool/cmd/root.go).
"""

from __future__ import annotations

import argparse
import sys


from ..envflags import env_default

_SCHEMES = ("ecdsa-p256", "ed25519", "ecdsa-p384", "ecdsa-p521")
_USIG_SPECS = ("auto", "NATIVE_ECDSA", "SOFT_ECDSA", "HMAC_SHA256")


def _env_default(name: str, fallback, choices=None):
    return env_default("KEYTOOL", name, fallback, choices)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="keytool", description="minbft-tpu keystore generation"
    )
    sub = p.add_subparsers(dest="command", required=True)
    g = sub.add_parser("generate", help="generate a testnet keys.yaml")
    g.add_argument(
        "-o",
        "--output",
        default=_env_default("output", "keys.yaml"),
        help="output path (default keys.yaml)",
    )
    g.add_argument(
        "-n",
        "--replicas",
        type=int,
        default=_env_default("replicas", 3),
        help="number of replicas",
    )
    g.add_argument(
        "--clients",
        type=int,
        default=_env_default("clients", 1),
        help="number of clients",
    )
    g.add_argument(
        "--scheme",
        choices=_SCHEMES,
        default=_env_default("scheme", "ecdsa-p256", choices=_SCHEMES),
        help="signature scheme for replica/client keys",
    )
    g.add_argument(
        "--usig",
        choices=_USIG_SPECS,
        default=_env_default("usig", "auto", choices=_USIG_SPECS),
        help="USIG keyspec (auto = native module if buildable, else soft)",
    )
    g.add_argument(
        "--macs",
        action="store_true",
        default=bool(_env_default("macs", 0)),
        help="also generate pairwise-MAC material (MAC authentication scheme)",
    )
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "generate":
        from .keystore import generate_testnet_keys

        store = generate_testnet_keys(
            n=args.replicas,
            n_clients=args.clients,
            scheme=args.scheme,
            usig_spec=args.usig,
            with_macs=args.macs,
        )
        store.save(args.output)
        print(
            f"wrote {args.output}: {args.replicas} replicas, "
            f"{args.clients} clients, scheme={store.scheme}, "
            f"usig={store.usig_spec}"
            + (", pairwise MACs" if store.mac_keys is not None else ""),
            file=sys.stderr,
        )
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
