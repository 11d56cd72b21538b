"""repro_torch.benchmarks - the port's benchmark suite (``run.py``).

  paper_figures  one benchmark per paper figure / table: closed-form curves
                 and Monte Carlo overlays (``core.mc``)
  layer_snr      per-site SNR_T of musicgen-medium under per-site B_ADC
                 overrides (``site_snr_records``)
  kernel_bench   the bit-serial kernels (the port's and the frozen seed's)
                 and paged attention: times, bytes and operations

The reference's serve bench, model energy, whole-model SNR sweep, roofline
and regression gate wait for later slices (ROADMAP).
"""
