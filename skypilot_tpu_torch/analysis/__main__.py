"""CLI: ``python -m skypilot_tpu_torch.analysis --audit [--json]``.

Runs the compile-budget audit (analysis/audit.py) on the card, or on
the host with ``--device cpu``.  Exit status is the CI contract: 0 when
every budget holds, 1 on any failed check.  ``--json`` prints one
object, the reference CLI's keys without the linter's (the port has no
linter: ``new``, ``suppressed`` and ``stale_baseline`` stay empty).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.analysis',
        description='compile-budget audit of the port: graph keys, host '
                    'reads, f64 and in-place arenas of the hot paths')
    parser.add_argument('--audit', action='store_true',
                        help='run the audit (the only analysis here)')
    parser.add_argument('--json', action='store_true', dest='as_json',
                        help='machine-readable output')
    parser.add_argument('--device', default=None,
                        help="device to run on (default: the CUDA card; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    if not args.audit:
        parser.print_usage(sys.stderr)
        print('nothing to do: pass --audit', file=sys.stderr)
        return 2

    from skypilot_tpu_torch.analysis import audit as audit_lib
    report = audit_lib.run_audit(device=args.device)
    failed = sum(1 for e in report['entries'] for c in e['checks']
                 if c['status'] == 'fail')
    if args.as_json:
        print(json.dumps({'new': [], 'suppressed': [], 'stale_baseline': [],
                          'graph': None, 'audit': report,
                          'ok': not failed}, indent=1))
    else:
        for entry in report['entries']:
            for check in entry['checks']:
                mark = {'ok': ' ok ', 'fail': 'FAIL',
                        'skip': 'skip'}[check['status']]
                print(f"audit [{mark}] {entry['entry']}."
                      f"{check['name']}: {check['detail']}")
        print(f'{failed} audit failure(s)')
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
