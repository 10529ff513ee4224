"""Gluon basic layers: ``Sequential``, ``HybridSequential``, ``Dense``,
``Activation``, ``BatchNorm`` and ``Flatten``.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (``Sequential``
:18, ``HybridSequential`` :40, ``Dense`` :62, ``Activation`` :111,
``BatchNorm`` :146, ``Flatten`` :228), the layers the ResNets use.  Each
lowers to the op of the same name in the shared registry.
"""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "BatchNorm", "Flatten"]


class Sequential(Block):
    """Stacks Blocks sequentially."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks sequentially."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class Dense(HybridBlock):
    """``out = act(dot(x, W.T) + b)`` through the FullyConnected op."""

    def __init__(self, units, activation=None, use_bias=True,
                 flatten=True, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Activation(HybridBlock):
    """An activation ('relu', 'sigmoid', 'tanh', 'softrelu')."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``; the running statistics are aux
    parameters that the BatchNorm op's extra outputs update.  ``scale``
    False is the op's ``fix_gamma``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)


class Flatten(HybridBlock):
    """Flattens to 2-D."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)
