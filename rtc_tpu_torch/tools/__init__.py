"""The measurement tools (counterparts of rtc_tpu's root scripts), each
runnable as `python -m rtc_tpu_torch.tools.<name>`, on the card unless
--device cpu is given:

  bench         bench.py: rays/s of one scene's frame, the kernel parity
                gate, the suite of scenes, and the tile sweep
  perf_probe    perf_probe.py: the frame's stages timed, --gathers,
                --visits (the K1 ordered walk's visits), --kernel-micro
  kernel_sweep  kernel_sweep.py: leaf x CUDA block size on the cow's
                primary and reflected wavefronts
  graft_entry   __graft_entry__.py: entry() and dryrun_multichip(n), the
                sharded train step over torch.distributed ranks
  walk          the ordered walk's visits, counted, and its scans modelled
  common        the rays in render()'s order, device names and timing
"""
