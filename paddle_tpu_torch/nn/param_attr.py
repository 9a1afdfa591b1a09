"""ParamAttr (the port of `paddle_tpu/nn/param_attr.py`; ref
python/paddle/fluid/param_attr.py): the configuration bag a parameter's
creator reads (`Layer.create_parameter`, `create_parameter`)."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, False (no parameter), a ParamAttr, a name, or an
        initializer, as a ParamAttr (or None / False)."""
        if attr is None:
            return None
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        from .initializer import Initializer
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")
