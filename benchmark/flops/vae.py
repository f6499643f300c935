"""Operations of one VAE decode (the SD VAE or the Flux AE) of a (b, h, w)
latent: every convolution's 2 M K N and the mid block's single-head
attention over all h w pixels (4 B L^2 C), at the f32 rate: the
configuration decodes in f32 with TF32 off."""


def count(cfg: dict, info: dict) -> dict:
    b, h, w = info["b"], info["h"], info["w"]
    ch, mult, nrb, z = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"], cfg["z_channels"]

    def conv(n, cin, cout, k=3):
        return 2.0 * b * n * k * k * cin * cout

    c = ch * mult[-1]
    n = h * w
    total = conv(n, z, z, 1) if cfg["has_quant_conv"] else 0.0
    total += conv(n, z, c)
    res = lambda n, i, o: conv(n, i, o) + conv(n, o, o) + (conv(n, i, o, 1) if i != o else 0)
    total += 2 * res(n, c, c) + 4 * conv(n, c, c, 1) + 4.0 * b * n * n * c
    for i in reversed(range(len(mult))):
        o = ch * mult[i]
        for _ in range(nrb + 1):
            total += res(n, c, o)
            c = o
        if i:
            n *= 4
            total += conv(n, c, c)
    total += conv(n, c, 3)
    return {"f32": total}
