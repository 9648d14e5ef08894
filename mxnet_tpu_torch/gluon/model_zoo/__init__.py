"""Model zoo of the port (counterpart of ``mxnet_tpu/gluon/model_zoo``):
the vision models, BERT and the Transformer."""
from . import bert, transformer, vision
from .bert import get_bert_model
from .transformer import get_transformer_model

__all__ = ["vision", "bert", "transformer", "get_model", "get_bert_model",
           "get_transformer_model", "build"]

_NLP_MODELS = {"bert_12_768_12": bert.bert_12_768_12,
               "bert_24_1024_16": bert.bert_24_1024_16,
               "transformer_base": transformer.transformer_base,
               "transformer_big": transformer.transformer_big}


def get_model(name, **kwargs):
    """A zoo network by name: a vision model, a BERT model or a
    Transformer."""
    fn = _NLP_MODELS.get(name.lower())
    return fn(**kwargs) if fn is not None else vision.get_model(name,
                                                                 **kwargs)


def build(arch: dict):
    """Rebuild a network from the record ``{"name", "kwargs"}`` that a zoo
    network keeps in ``_arch`` (what ``contrib.deploy`` stores)."""
    if arch["name"] == "BERTModel":
        return bert.BERTModel(**arch["kwargs"])
    return vision.build(arch)
