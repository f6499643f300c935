"""The port's ``RuntimeConfig`` for a run: every toggle as the card
resolves it by default ("auto"), whatever the environment's ``LDT_*``
overrides say, with the configuration's ``runtime`` entries on top."""


def configure(cfg: dict):
    from lightdiffusion_next_tpu_torch import config

    fields = {"packed_attn": "auto", "sage_attention": False, "qkv_fuse": "auto",
              "w8a8": "auto", "fused_ew": "auto", "flux_scan": "auto", "fused_attn": "auto"}
    fields.update(cfg.get("runtime", {}))
    config.set_config(config.RuntimeConfig(**fields))
