"""The port's tools (the counterparts of tools/), each run as
``python -m zerocaf_tpu_torch.tools.<name>``:

  pod_msm     the sharded MSM at 2^20 points over every mesh size the ranks
              allow: wall times, scaling efficiency, and the result checked
              bit for bit across mesh sizes;
  dist_smoke  one rank of the two-process smoke: a sharded MSM whose
              partials cross the process boundary, against the oracle.
"""
