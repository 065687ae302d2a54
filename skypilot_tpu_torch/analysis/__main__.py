"""CLI: ``python -m skypilot_tpu_torch.analysis [paths...]``.

Exit status is the CI contract: 0 = no NEW lint violations (baseline
matches are suppressed) and, with ``--audit``, every audit budget
holds; 1 otherwise.  ``--json`` emits one machine-readable object
(scripts/torch_lint.sh feeds this to CI); ``--update-baseline``
rewrites analysis/baseline.json from the current findings.  The lint
needs no card; the audit (analysis/audit.py) runs on the card, or on
the host with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from skypilot_tpu_torch.analysis import baseline as baseline_lib
from skypilot_tpu_torch.analysis import linter

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE_ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.analysis',
        description='skytpu-lint over the port: PyTorch- and CUDA-graph-'
                    'aware static analysis and the compile-budget audit')
    parser.add_argument('paths', nargs='*',
                        help='files/directories to lint (default: the '
                             'skypilot_tpu_torch package)')
    parser.add_argument('--json', action='store_true', dest='as_json',
                        help='machine-readable output')
    parser.add_argument('--baseline', default=None,
                        help='baseline file (default: '
                             'analysis/baseline.json)')
    parser.add_argument('--no-baseline', action='store_true',
                        help='report every violation, baseline ignored')
    parser.add_argument('--update-baseline', action='store_true',
                        help='rewrite the baseline from current '
                             'findings and exit 0')
    parser.add_argument('--audit', action='store_true',
                        help='also run the compile-budget audit (graph '
                             'keys, host reads, f64 and in-place arenas '
                             'of the hot paths)')
    parser.add_argument('--device', default=None,
                        help="the audit's device (default: the CUDA card; "
                             "'cpu' for the host)")
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule catalog and exit')
    parser.add_argument('--graph-stats', action='store_true',
                        help='print whole-program call-graph statistics; '
                             'exits 1 if the graph is degenerate (zero '
                             'functions, call edges, or thread entries) — '
                             'the CI self-check that the concurrency pass '
                             'is actually seeing the package')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in linter.RULES.values():
            print(f'{rule.code}  {rule.name:20s} {rule.summary}')
        return 0

    graph_stats = None
    if args.graph_stats:
        from skypilot_tpu_torch.analysis import graph as graph_lib
        graph_stats = graph_lib.build_package_graph(_REPO_ROOT).stats()
        if not args.as_json:
            for key, value in sorted(graph_stats.items()):
                print(f'graph {key}: {value}')
        if not (graph_stats['functions'] and graph_stats['call_edges']
                and graph_stats['thread_entries']):
            print('graph self-check FAILED: degenerate call graph '
                  f'({graph_stats})', file=sys.stderr)
            return 1

    paths = args.paths or [_PACKAGE_ROOT]
    violations = linter.lint_paths(paths, root=_REPO_ROOT)

    if args.update_baseline:
        n = baseline_lib.update_baseline(
            violations, path=args.baseline)
        print(f'baseline updated: {n} entries '
              f'({args.baseline or baseline_lib.BASELINE_PATH})')
        return 0

    baseline = ({} if args.no_baseline
                else baseline_lib.load_baseline(args.baseline))
    new, suppressed, stale = baseline_lib.diff_baseline(
        violations, baseline)

    audit_report = None
    audit_failed = 0
    if args.audit:
        from skypilot_tpu_torch.analysis import audit as audit_lib
        audit_report = audit_lib.run_audit(device=args.device)
        audit_failed = sum(1 for e in audit_report['entries']
                           for c in e['checks'] if c['status'] == 'fail')

    if args.as_json:
        print(json.dumps({
            'new': [v.as_dict() for v in new],
            'suppressed': [v.as_dict() for v in suppressed],
            'stale_baseline': stale,
            'graph': graph_stats,
            'audit': audit_report,
            'ok': not new and not audit_failed,
        }, indent=1))
    else:
        for v in new:
            print(v.format())
        if audit_report is not None:
            for entry in audit_report['entries']:
                for check in entry['checks']:
                    mark = {'ok': ' ok ', 'fail': 'FAIL',
                            'skip': 'skip'}[check['status']]
                    print(f"audit [{mark}] {entry['entry']}."
                          f"{check['name']}: {check['detail']}")
        print(f'{len(new)} new violation(s), {len(suppressed)} '
              f'suppressed by baseline, {len(stale)} stale baseline '
              f'entr{"y" if len(stale) == 1 else "ies"}'
              + (f', {audit_failed} audit failure(s)'
                 if args.audit else ''))
        if stale:
            print('stale (fixed — prune with --update-baseline):')
            for e in stale:
                print(f"  {e['path']}:{e['line']} {e['rule']} "
                      f"{e['text']}")
    return 1 if (new or audit_failed) else 0


if __name__ == '__main__':
    sys.exit(main())
