"""CLI for store maintenance: ``python -m repro_torch.store gc <path>``.

``gc`` compacts a profile store in place — live event shards per
namespace are rewritten into one content-addressed shard, and
stale-``cache_version`` orphans plus corrupt files are deleted. Safe to
run against a store that concurrent writers are appending to: writes
are atomic and content-addressed, so the worst case is a shard written
mid-gc surviving until the next gc.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.store.profile_store import ProfileStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.store",
        description="Profile-store maintenance commands.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    gc = sub.add_parser(
        "gc", help="compact event shards, drop stale/corrupt entries")
    gc.add_argument("path", help="store directory")
    gc.add_argument("--json", action="store_true",
                    help="emit the stats dict as JSON")
    args = ap.parse_args(argv)

    if args.cmd == "gc":
        stats = ProfileStore(args.path).gc()
        if args.json:
            print(json.dumps(stats, sort_keys=True))
        else:
            print(f"gc {args.path}: "
                  f"{stats['namespaces']} namespace(s), "
                  f"shards {stats['shards_before']} -> "
                  f"{stats['shards_after']} "
                  f"({stats['events_live']} live events, "
                  f"{stats['events_dropped']} dropped), "
                  f"builds kept {stats['builds_kept']} / "
                  f"dropped {stats['builds_dropped']}")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
