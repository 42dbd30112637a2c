"""The benchmark of rtc_tpu_torch (run.py), its plain reference
(reference/) and its CPU tests (tests/)."""
