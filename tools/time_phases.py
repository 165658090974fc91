"""Time the phases that sum through BA, k-means and SIFT, on one tree.

Runs, in this process, `chip_smoke.py`'s phase 12 (the auxiliary ops,
whose part h solves the 1,024-camera synthetic BA problem by PCG), phase
4c (the default web `cli sfm` on 24 rendered 1024x768 views: SIFT, the
k-means vocabulary, BoW candidates, dense-Schur BA) and phase 9d (the
200-view aerial path with vocabulary-tree candidates), from the tree at
--root (default: this repository), and prints one JSON line: the card,
12h's LM iterations/s, 4c's timed wall and its `sfm/feature_extraction`,
9d's wall, its candidates after the word-seed gate and its
`sfm/build_words`.  Run it once per tree, in turns, to compare two trees
on one card (e.g. a parent commit unpacked by `git archive` beside this
one).  Needs one NVIDIA card; from the repository root:

    python3 tools/time_phases.py [--root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree whose phases run")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke

    card = chip_smoke.gpu_line()
    chip_smoke.build_phase()
    _, aux = chip_smoke.aux_phase(card)
    web = chip_smoke.web_path_phase()
    if len(web) == 3:               # a tree whose 4c keeps its folders
        chip_smoke.remove_runs(web[2]["runs"])
    web_stats = web[1]
    _, bow = chip_smoke.aerial_phase(matching="feature")
    stage = {ln.split()[0]: float(ln.split()[1].rstrip("s"))
             for ln in web_stats["stages"].splitlines() if ln.strip()}
    row = {"root": os.path.abspath(args.root), "card": card,
           "lm_iterations_per_s_12h":
           aux["h_solve"]["lm_iterations_per_s"],
           "web_seconds_4c": web_stats["seconds"],
           "web_feature_extraction_s_4c": stage["sfm/feature_extraction"],
           "bow_seconds_9d": bow["seconds"],
           "bow_pairs_after_word_gate_9d": bow["pairs_after_word_gate"],
           "bow_build_words_s_9d":
           bow["stages"]["sfm/build_words"]["total_s"]}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
