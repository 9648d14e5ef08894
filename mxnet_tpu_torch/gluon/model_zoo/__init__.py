"""Model zoo of the port (counterpart of ``mxnet_tpu/gluon/model_zoo``):
the vision models and BERT."""
from . import bert, vision
from .bert import get_bert_model

__all__ = ["vision", "bert", "get_model", "get_bert_model", "build"]

_BERT_MODELS = {"bert_12_768_12": bert.bert_12_768_12,
                "bert_24_1024_16": bert.bert_24_1024_16}


def get_model(name, **kwargs):
    """A zoo network by name: a vision model or a BERT model."""
    fn = _BERT_MODELS.get(name.lower())
    return fn(**kwargs) if fn is not None else vision.get_model(name,
                                                                 **kwargs)


def build(arch: dict):
    """Rebuild a network from the record ``{"name", "kwargs"}`` that a zoo
    network keeps in ``_arch`` (what ``contrib.deploy`` stores)."""
    if arch["name"] == "BERTModel":
        return bert.BERTModel(**arch["kwargs"])
    return vision.build(arch)
