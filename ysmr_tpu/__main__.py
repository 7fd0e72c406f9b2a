#!/usr/bin/env python3
"""Command-line launcher: ``python -m ysmr_tpu`` starts the full pipeline.

Mirrors the reference's top-level launcher (ysmr.py:18-21), which simply
calls ``ysmr()`` — the interactive batch entry point (file-selection dialog
or configured paths, per-file analysis, collation). Optional arguments let
non-interactive callers pass paths and a settings file directly:

    python -m ysmr_tpu [--settings tracking.ini] [--result-folder DIR]
                       [--serial] [video_or_csv ...]
"""

import argparse
import sys


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='ysmr_tpu',
        description='Accelerator-native bacterial video tracking and analysis.')
    parser.add_argument('paths', nargs='*', default=None,
                        help='video or .csv files to analyse; when omitted, '
                             'a file-selection dialog is used')
    parser.add_argument('--settings', default=None,
                        help='path to tracking.ini (created with defaults '
                             'when missing)')
    parser.add_argument('--result-folder', default=None,
                        help='output folder (default: dated folder next to '
                             'the first input)')
    parser.add_argument('--serial', action='store_true',
                        help='disable the per-file process pool')
    args = parser.parse_args(argv)
    from ysmr_tpu.main import ysmr
    result = ysmr(paths=args.paths or None, settings=args.settings,
                  result_folder=args.result_folder,
                  multiprocess=not args.serial)
    if result is None:
        return 1
    # nonzero exit when any file failed (result is [(path, df-or-None), ...])
    return 0 if all(res is not None for _, res in result) else 1


if __name__ == '__main__':
    sys.exit(cli())
