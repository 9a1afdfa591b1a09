"""Float64 references of the JAX package's vision models, for
tests/test_torch_vision.py.

    python tests/torch_vision_ref.py OUT.npz

For each model of `MODELS`, built by the JAX package and given seeded
f32 weights (`weights`), the script saves that state dict, a seeded input, a seeded
projection `cot` of the output, and, from a `jax.jit` of
`jax.value_and_grad` through `Layer.functional_call` with every weight,
buffer and input cast to float64 (x64 enabled): the training-mode
output, the gradient of sum(output * cot) for every parameter and the
buffers after the call (the BatchNorm running statistics). x64 is a
process-wide JAX setting, so the references are made in a process of
their own. Beside them: resnet50's state dict with an eval-mode
float64 forward, and vgg16's (classifier included) state-dict keys and
shapes. Importing this module touches no JAX setting.

At batch 2, a BatchNorm that sees two values a channel (resnet18's
last stage at 32 x 32) makes f32 gradients ill-conditioned: the JAX
package's own f32 gradients are then 5% from these float64 ones. The
inputs are sized so that every BatchNorm sees at least eight values a
channel, where both packages' f32 results lie within 1e-4 of float64.
"""
import json
import sys

import numpy as np

SEED = 5

# name -> (constructor over a package's `vision.models`, input shape)
MODELS = {
    "lenet": (lambda M: M.LeNet(), (2, 1, 28, 28)),
    "resnet18": (lambda M: M.resnet18(num_classes=10), (2, 3, 64, 64)),
    "vgg11_bn_features": (lambda M: M.vgg11(batch_norm=True,
                                            num_classes=0),
                          (2, 3, 32, 32)),
    "mobilenet_v1": (lambda M: M.mobilenet_v1(scale=0.25, num_classes=10),
                     (2, 3, 128, 128)),
    "mobilenet_v2": (lambda M: M.mobilenet_v2(scale=0.25, num_classes=10),
                     (2, 3, 128, 128)),
}


# resnet50's eval-mode forward is checked at this input
RESNET50_INPUT = (1, 3, 64, 64)


def build(M, name):
    """The model, with MobileNet V2's classifier dropout off (the two
    packages draw different masks)."""
    model = MODELS[name][0](M)
    if name == "mobilenet_v2":
        model.classifier[0].p = 0.0
    return model


def weights(state_dict, seed):
    """Seeded f32 weights for a state dict: conv and linear weights
    He-normal over their fan-in (a conv's [out, in, kh, kw], a linear's
    [in, out]), BatchNorm scales in [0.5, 1.5], biases in [-0.1, 0.1],
    the running statistics at 0 and 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in state_dict.items():
        shape = tuple(v.shape)
        if k.endswith("_mean"):
            a = np.zeros(shape)
        elif k.endswith("_variance"):
            a = np.ones(shape)
        elif len(shape) == 1:
            a = (rng.uniform(0.5, 1.5, shape) if k.endswith("weight")
                 else rng.uniform(-0.1, 0.1, shape))
        else:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        out[k] = a.astype("f4")
    return out


def main(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from paddle_tpu.nn import initializer
    from paddle_tpu.vision import models as M

    # the layers are built with zeros (the JAX initializers compile one
    # random program per shape) and take `weights(...)` instead
    initializer.Initializer.__call__ = (
        lambda self, shape, dtype="float32": np.zeros(shape, "f4"))
    blobs = {}
    for i, (name, (_, shape)) in enumerate(MODELS.items()):
        model = build(M, name)
        sd = weights(model.state_dict(), SEED + i)
        model.set_state_dict(sd)
        for k, v in sd.items():
            blobs[f"{name}/sd/{k}"] = v
        x = np.random.RandomState(6).uniform(-1, 1, shape).astype("f4")
        model.train()
        params, buffers = model.functional_state()
        f64 = {k: jnp.asarray(np.asarray(v), jnp.float64)
               for k, v in params.items()}
        b64 = {k: jnp.asarray(np.asarray(v), jnp.float64)
               for k, v in buffers.items()}
        x64 = jnp.asarray(x, jnp.float64)

        def forward(p, b, xx):
            out, new_b = model.functional_call(p, b, xx)
            return out._data, new_b

        out_shape = jax.eval_shape(forward, f64, b64, x64)[0].shape
        cot = np.random.RandomState(7).uniform(-1, 1, out_shape).astype("f4")

        def loss_fn(p, b, xx):
            out, new_b = forward(p, b, xx)
            return jnp.sum(out * jnp.asarray(cot, jnp.float64)), (out, new_b)

        (_, (out, new_b)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(f64, b64, x64)
        blobs[f"{name}/x"] = x
        blobs[f"{name}/cot"] = cot
        blobs[f"{name}/out"] = np.asarray(out)
        for k, g in grads.items():
            blobs[f"{name}/grad/{k}"] = np.asarray(g)
        for k, b in new_b.items():
            blobs[f"{name}/buffer/{k}"] = np.asarray(b)
    # resnet50: its state dict and an eval-mode float64 forward
    model = M.resnet50()
    sd = weights(model.state_dict(), SEED + len(MODELS))
    model.set_state_dict(sd)
    model.eval()
    params, buffers = model.functional_state()
    x = np.random.RandomState(8).uniform(-1, 1, RESNET50_INPUT).astype("f4")
    out = jax.jit(lambda p, b, xx: model.functional_call(p, b, xx)[0]._data)(
        {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in params.items()},
        {k: jnp.asarray(np.asarray(v), jnp.float64)
         for k, v in buffers.items()}, jnp.asarray(x, jnp.float64))
    for k, v in sd.items():
        blobs[f"resnet50/sd/{k}"] = v
    blobs["resnet50/x"] = x
    blobs["resnet50/out"] = np.asarray(out)
    # vgg16 with its classifier: the state dict's keys and shapes
    shapes = [(k, list(v.shape)) for k, v in M.vgg16().state_dict().items()]
    blobs["vgg16/shapes"] = np.asarray(json.dumps(shapes))
    np.savez(out_path, **blobs)


if __name__ == "__main__":
    main(sys.argv[1])
