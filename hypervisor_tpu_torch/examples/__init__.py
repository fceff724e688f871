"""The port's example entry points, each run as a module of the package:

  * `demo` — the headline capabilities end to end, ending in the fused
    batched governance pipeline and the device plane on the card;
  * `multichip` — the mesh walkthroughs on an explicit virtual mesh
    (8 shards of one device);
  * `hv_top`, `metrics_watch`, `trace_watch` — the terminal watchers
    over the health, metrics and trace planes (`_watch_common` holds
    their shared loop and traffic driver);
  * `dashboard.app`, `dashboard.web` — the five-panel dashboard (rich,
    matplotlib, streamlit or the stdlib browser page).

Every one takes `--device` (the card by default; `cpu` on a machine
without one) and never drops to the CPU by itself:
`python -m hypervisor_tpu_torch.examples.demo --device cpu`.
"""
