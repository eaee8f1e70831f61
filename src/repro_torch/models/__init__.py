"""The LM stack of the port: configs, layers, attention, the Mamba2 mixer,
MoE, blocks and the model's forward (with a gradient), prefill / decode
API for every family of the reference (dense, MoE, SSM, hybrid, vision,
enc-dec)."""
