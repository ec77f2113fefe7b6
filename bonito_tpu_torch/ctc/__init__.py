def __getattr__(name):
    # Model/basecall load lazily (``util.load_symbol``)
    from importlib import import_module
    if name == "Model":
        return import_module("bonito_tpu_torch.ctc.model").Model
    if name == "basecall":
        return import_module("bonito_tpu_torch.ctc.basecall").basecall
    raise AttributeError(name)
