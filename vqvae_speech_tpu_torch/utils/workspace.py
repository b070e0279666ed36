"""Experiment-root hygiene shared by the quality/experiment-family scripts.

A copy of ``vqvae_speech_tpu/utils/workspace.py``.
"""
import os
import shutil

# the subdirectories a quality/experiment run owns inside its root; a
# stale one from an interrupted or differently-configured run poisons the
# next run (mixed-scale corpora, wrong auto-resume checkpoints)
RUN_SUBDIRS = ("raw", "features", "experiments", "results")


def clean_room(root):
    """Remove a run root's owned subdirectories (corpus generation is
    seeded, so a rebuild is exact).  One shared list — adding a new owned
    subdirectory here cleans it in every runner."""
    for sub in RUN_SUBDIRS:
        shutil.rmtree(os.path.join(root, sub), ignore_errors=True)
