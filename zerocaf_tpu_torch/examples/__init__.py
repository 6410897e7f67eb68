"""Examples of the port's public surface, each run as
``python -m zerocaf_tpu_torch.examples.<name>`` (on the first CUDA card) and
each with a ``main(device=None)`` that checks its own results:

  basic_ops   batched k B, Ristretto encoding and its round trip;
  msm_demo    Pippenger MSM on one device, then through ``msm_sharded`` on a
              one-rank mesh;
  serving     the Engine's keygen, ECDH, hash-to-group and MSM flows.
"""
