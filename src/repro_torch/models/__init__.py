"""The LM stack of the port: configs, layers, the Mamba2 mixer, blocks and
the model's prefill / decode API.  Family ``"ssm"`` (mamba2) is ported; the
attention, MoE, vision and enc-dec families are ROADMAP A12."""
