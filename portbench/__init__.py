"""The benchmark of ``repro_torch`` on one H100: ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
