"""Evaluation of the port: the copies of the JAX package's eval runners,
each driving the port's pipeline on an explicit `device` (default cuda).

- `edits`: the edit-distance scorer (the native banded Myers distance);
- `stats`: median-of-N timing (`run_stats`, `summarize`);
- `scrape`: the `[M::]` phase-log contract (`scrape_log`);
- `synth`, `scale`: the synthetic instance generators (`build_instance`,
  `build_heldout_instance`: byte-identical files from the same seed into
  the same cache directory names as the JAX package's), the scaling run
  (`run_one`), the progressive panel sweep (`progressive_subsets`) and
  the held-out coverage sweep (`heldout_sweep`); `phi-torch-scale`;
- `batch`: the reads x coverage matrix (`run_matrix`) and its CSVs;
- `baselines`: the best-single-panel-haplotype and greedy stand-ins;
- `crossval`: leave-one-out over a panel;
- `throughput`: sketch and join throughput; `phi-torch-throughput`;
- `frontier`: the optimality failure-frontier mapper;
- `groundtruth`, `floor_diag`, `merge_gt`: the ground-truth accuracy chain
  (`run_grid` of held-out truths against a panel with the best-single-hap
  floor and the certification escalation, the R = 1 ceiling diagnosis,
  the merge of per-sample shards);
- `plots`: the matrix and scaling figures (`phi-torch-plots`; matplotlib
  is imported only to draw);
- `datasets`, `competitors`: the tool-gated dataset build
  (`phi-torch-datasets`) and the vg / PanGenie runners, whose native
  steps run here and whose binaries run where they are on PATH.
"""

from phi_tpu_torch.eval.edits import edit_stats
from phi_tpu_torch.eval.scale import build_instance
from phi_tpu_torch.eval.scrape import scrape_log

__all__ = ["build_instance", "edit_stats", "scrape_log"]
