"""
Model zoo: the LSTM-CRF family (fast/hac), the transformer-CRF family
(sup) and the conv-CTC family (r9.4.1 fast) as bonito-style config dicts,
schema-compatible with bonito_tpu's config functions and upstream bonito's
``dna_r10.4.1@v4.x``, ``@v5.0``, ``dna_r9.4.1@v2`` and (``rnn_crf_config``)
the old-style ``dna_r9.4.1@v3.x`` configs. The packages
are named ``bonito.crf``, ``bonito.transformer`` and ``bonito.ctc``, the
upstream names that both bonito_tpu and this port map onto their own
families, so a directory written here loads in either package.
"""


def _conv(insize, size, winlen, stride=1, activation="swish", norm="batchnorm"):
    return {
        "type": "convolution", "insize": insize, "size": size, "bias": True,
        "winlen": winlen, "stride": stride, "padding": winlen // 2,
        "activation": activation, "norm": norm,
    }


def _lstm(size, reverse):
    return {"type": "lstm", "size": size, "insize": size, "bias": True,
            "reverse": int(reverse)}


def lstm_crf_config(
    features=1024, num_layers=5, state_len=5, stride=6, winlen=19,
    first_conv=16, blank_score=2.0, scale=None, clamp=5.0,
    batchsize=96, chunksize=10000, overlap=500, sample_rate=5000,
    qscale=1.05, qbias=0.2, scaling_strategy="pa", standardisation=None,
    quantize=True,
):
    """LSTM-CRF family (schema of dna_r10.4.1@v4.3.toml). ``quantize`` is
    the shipped configs' default, true: ``util.load_model(...,
    quantize=None)`` then runs the int8 LSTM chain and the int8 CRF head."""
    if standardisation is None and scaling_strategy == "pa":
        standardisation = {"standardise": 1, "mean": 90.0, "stdev": 23.0}
    sublayers = [
        _conv(1, first_conv, 5, 1),
        _conv(first_conv, first_conv, 5, 1),
        _conv(first_conv, features, winlen, stride, activation="tanh"),
        {"type": "permute", "dims": [2, 0, 1]},
        *[_lstm(features, (num_layers - i) % 2) for i in range(num_layers)],
        {
            "type": "linearcrfencoder", "insize": features, "n_base": 4,
            "state_len": state_len, "bias": False, "blank_score": blank_score,
            **({"scale": scale, "activation": "tanh"} if scale is not None else {}),
        },
    ]
    if clamp is not None:
        sublayers.append({"type": "clamp", "min": -clamp, "max": clamp})
    return {
        "model": {"package": "bonito.crf"},
        "labels": {"labels": ["N", "A", "C", "G", "T"]},
        "input": {"features": 1},
        "global_norm": {"state_len": state_len},
        "scaling": {"strategy": scaling_strategy},
        **({"standardisation": standardisation} if standardisation else {}),
        "run_info": {"sample_rate": sample_rate},
        "qscore": {"scale": qscale, "bias": qbias},
        "encoder": {"type": "serial", "sublayers": sublayers},
        "basecaller": {"batchsize": batchsize, "chunksize": chunksize,
                       "overlap": overlap, "quantize": quantize},
    }


def transformer_crf_config(
    d_model=512, nhead=8, depth=18, dim_feedforward=2048,
    attn_window=(127, 128), state_len=5, conv_stride=12, upsample=2,
    blank_score=2.0, crf_scale=5.0,
    batchsize=128, chunksize=12000, overlap=600, sample_rate=5000,
    qscale=1.05, qbias=1.3, scaling_strategy="pa", standardisation=None,
):
    """Transformer-CRF "sup" family (schema of dna_r10.4.1@v5.0.toml): the
    whole model tree sits under ``[model]``; no ``basecaller.quantize`` key,
    so it loads in bf16. ``conv_stride`` is the fixed 1, 1, 3, 2, 2 of the
    five convs (kept as an argument for bonito_tpu's signature)."""
    if standardisation is None and scaling_strategy == "pa":
        standardisation = {"standardise": 1, "mean": 90.0, "stdev": 23.0}
    convs = [
        _conv(1, 64, 5, 1),
        _conv(64, 64, 5, 1),
        _conv(64, 128, 9, 3),
        _conv(128, 128, 9, 2),
        _conv(128, d_model, 5, 2),
    ]
    encoder = {
        "type": "namedserial",
        "conv": {"type": "serial", "sublayers": convs},
        "transformer_encoder": {
            "type": "stack",
            "depth": depth,
            "layer": {
                "type": "transformerencoderlayer",
                "d_model": d_model, "nhead": nhead,
                "dim_feedforward": dim_feedforward,
                "deepnorm_alpha": round((2 * depth) ** 0.25, 7),
                "deepnorm_beta": round((8 * depth) ** -0.25, 7),
                "attn_window": list(attn_window),
            },
        },
        "upsample": {"type": "linearupsample", "d_model": d_model,
                     "scale_factor": upsample},
        "crf": {
            "type": "linearcrfencoder", "insize": d_model, "n_base": 4,
            "state_len": state_len, "bias": False,
            "blank_score": blank_score, "scale": crf_scale,
            "activation": "tanh",
        },
    }
    return {
        "model": {
            "package": "bonito.transformer",
            "type": "seqdistmodel",
            "seqdist": {"state_len": state_len,
                        "alphabet": ["N", "A", "C", "G", "T"]},
            "encoder": encoder,
        },
        "scaling": {"strategy": scaling_strategy},
        **({"standardisation": standardisation} if standardisation else {}),
        "run_info": {"sample_rate": sample_rate},
        "qscore": {"scale": qscale, "bias": qbias},
        "basecaller": {"batchsize": batchsize, "chunksize": chunksize,
                       "overlap": overlap},
    }


def conv_ctc_config(batchsize=512, chunksize=4000, overlap=500):
    """QuartzNet-style conv-CTC family (schema of upstream
    ``dna_r9.4.1@v2.toml``): C1, B1..B5, C2, C3 with the published repeats
    2, 7, 4, 9, 6, as bonito_tpu's ``conv_ctc_config``. No ``scaling``,
    ``standardisation`` or ``run_info``: reads are scaled by quantiles."""
    def block(filters, repeat, kernel, stride=1, separable=True,
              residual=True, dilation=1, dropout=0.05):
        return {
            "filters": filters, "repeat": repeat, "kernel": [kernel],
            "stride": [stride], "dilation": [dilation], "dropout": dropout,
            "residual": residual, "separable": separable,
        }
    return {
        "model": {"package": "bonito.ctc"},
        "labels": {"labels": ["N", "A", "C", "G", "T"]},
        "input": {"features": 1},
        "encoder": {"activation": "swish"},
        "qscore": {"scale": 0.9, "bias": 0.0},
        "block": [
            block(344, 1, 9, stride=3, separable=False, residual=False),
            block(424, 2, 115),
            block(464, 7, 5),
            block(456, 4, 123),
            block(440, 9, 9),
            block(280, 6, 31),
            block(384, 1, 67, separable=True, residual=False),
            block(48, 1, 15, separable=False, residual=False),
        ],
        "basecaller": {"batchsize": batchsize, "chunksize": chunksize,
                       "overlap": overlap},
    }


def rnn_crf_config(features=768, state_len=5, stride=5, winlen=19,
                   scale=5.0, blank_score=2.0, activation="swish",
                   rnn_type="lstm", batchsize=96, chunksize=9996,
                   overlap=500, quantize=True):
    """An old-style LSTM-CRF config (the schema of upstream's r9.4.1 v3
    configs, ``dna_r9.4.1@v3.1.toml``): ``[encoder]`` holds the keyword
    arguments of ``crf.model.rnn_encoder`` instead of a layer tree. The
    widths are ``rnn_encoder``'s defaults (5 LSTM layers of 768); no
    ``scaling``, so reads are scaled by their quantiles."""
    return {
        "model": {"package": "bonito.crf"},
        "labels": {"labels": ["N", "A", "C", "G", "T"]},
        "input": {"features": 1},
        "global_norm": {"state_len": state_len},
        "encoder": {"stride": stride, "winlen": winlen, "scale": scale,
                    "features": features, "rnn_type": rnn_type,
                    "activation": activation, "blank_score": blank_score},
        "basecaller": {"batchsize": batchsize, "chunksize": chunksize,
                       "overlap": overlap, "quantize": quantize},
    }


# name -> config function (bonito_tpu.models.MODELS)
MODELS = {
    "dna_r10.4.1_e8.2_400bps_fast@v4.3": lambda: lstm_crf_config(
        features=96, num_layers=5, state_len=3, stride=5,
        blank_score=2.0, batchsize=1024, chunksize=6000, overlap=500),
    "dna_r10.4.1_e8.2_400bps_hac@v4.3": lambda: lstm_crf_config(),
    "rna004_130bps_fast@v3.0.1": lambda: lstm_crf_config(
        features=96, num_layers=5, state_len=3, stride=5,
        batchsize=1024, chunksize=6000, overlap=500, sample_rate=4000),
    "rna004_130bps_hac@v3.0.1": lambda: lstm_crf_config(sample_rate=4000),
    "dna_r10.4.1_e8.2_400bps_sup@v5.0": lambda: transformer_crf_config(),
    "dna_r9.4.1_e8_fast@v2": lambda: conv_ctc_config(),
    "rna004_130bps_sup@v5.0": lambda: transformer_crf_config(
        sample_rate=4000),
}


def get_config(name):
    """The config dict of a ``MODELS`` entry; an unknown name raises, as
    in bonito_tpu (whose table has no entry for the train CLI's default
    ``dna_r9.4.1@v3.1`` either: pass ``--config`` a file)."""
    try:
        return MODELS[name]()
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODELS)}") from None
