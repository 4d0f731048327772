"""Float64 numpy forwards of the model layers and networks.

Written from the architecture (reference models/*.py), independently of
``dcd_isaac_tpu.models``; it only reads the same parameter names. Used by
the CPU layer tests and by the chip tests that compare the networks'
forward on the GPU with it.
"""

import numpy as np


def f64(tree):
    if isinstance(tree, dict):
        return {k: f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def softplus(x):
    return np.logaddexp(0.0, x)


def relu(x):
    return np.maximum(x, 0.0)


def dense(p, x):
    y = x @ p['kernel']
    return y + p['bias'] if 'bias' in p else y


def conv(p, x, stride=1):
    """VALID NHWC convolution, kernel (kh, kw, C, F), any batch dims."""
    k = p['kernel']
    kh, kw = k.shape[:2]
    H, W = x.shape[-3:-1]
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    out = 0.0
    for i in range(kh):
        for j in range(kw):
            patch = x[..., i:i + stride * (Ho - 1) + 1:stride,
                      j:j + stride * (Wo - 1) + 1:stride, :]
            out = out + patch @ k[i, j]
    return out + p['bias']


def lstm_cell(p, carry, x):
    c, h = carry
    z = {g: x @ p['i' + g]['kernel'] + h @ p['h' + g]['kernel']
         + p['h' + g]['bias'] for g in 'ifgo'}
    c2 = sigmoid(z['f']) * c + sigmoid(z['i']) * np.tanh(z['g'])
    h2 = sigmoid(z['o']) * np.tanh(c2)
    return (c2, h2), h2


def gru_cell(p, h, x):
    r = sigmoid(dense(p['ir'], x) + dense(p['hr'], h))
    z = sigmoid(dense(p['iz'], x) + dense(p['hz'], h))
    n = np.tanh(dense(p['in'], x) + r * dense(p['hn'], h))
    h2 = (1.0 - z) * n + z * h
    return h2, h2


def rnn_step(arch, p, carry, x, mask):
    """Masked RNN step: the carry is zeroed where mask == 0."""
    m = mask[..., None]
    if arch == 'lstm':
        return lstm_cell(p, (carry[0] * m, carry[1] * m), x)
    return gru_cell(p, carry * m, x)


def one_hot(i, n):
    return np.eye(n)[np.asarray(i, np.int64)]


def multigrid(p, obs, carry, mask, *, scalar_dim, arch='lstm'):
    """MultigridNetwork step → (logits, value, carry)."""
    x = relu(conv(p['image_conv'], obs['image'] / 10.0))
    parts = [x.reshape(*x.shape[:-3], -1)]
    scalar = obs.get('direction', obs.get('time_step'))
    parts.append(dense(p['scalar_embed'], one_hot(scalar, scalar_dim)))
    if 'random_z' in obs:
        parts.append(obs['random_z'])
    x = np.concatenate(parts, -1)
    carry, core = rnn_step(arch, p['core']['cell'], carry, x, mask)
    a = np.tanh(dense(p['actor_fc1'], np.tanh(dense(p['actor_fc0'], core))))
    v = np.tanh(dense(p['critic_fc1'], np.tanh(dense(p['critic_fc0'], core))))
    return dense(p['actor_head'], a), dense(p['critic_head'], v)[..., 0], carry


def multigrid_sequence(p, obs, carry, masks, **kw):
    logits, values = [], []
    for t in range(masks.shape[0]):
        o = {k: v[t] for k, v in obs.items()}
        lg, v, carry = multigrid(p, o, carry, masks[t], **kw)
        logits.append(lg)
        values.append(v)
    return np.stack(logits), np.stack(values), carry


def walker(p, x):
    """Walker student/teacher trunk+heads → (mean, log_std, value)."""
    a = np.tanh(dense(p['actor2'], np.tanh(dense(p['actor1'], x))))
    c = np.tanh(dense(p['critic2'], np.tanh(dense(p['critic1'], x))))
    mean = dense(p['dist']['mean'], a)
    log_std = np.broadcast_to(p['dist']['log_std'], mean.shape)
    return mean, log_std, dense(p['critic_head'], c)[..., 0]


def carracing(p, obs):
    """CarRacing student → (alpha, beta, value)."""
    strides = [2, 2, 2, 2, 1, 1]
    x = obs
    for i, s in enumerate(strides):
        x = relu(conv(p[f'conv{i}'], x, s))
    x = x.reshape(*x.shape[:-3], -1)
    ha = relu(dense(p['actor_fc'], x))
    alpha = 1.0 + softplus(dense(p['fc_alpha'], ha))
    beta = 1.0 + softplus(dense(p['fc_beta'], ha))
    hc = relu(dense(p['critic_fc'], x))
    return alpha, beta, dense(p['critic_head'], hc)[..., 0]


def carracing_teacher(p, obs, time_step_dim):
    """Beta-head sketch teacher → (alpha, beta, value)."""
    x = conv(p['conv2'], conv(p['conv1'], obs['image']))
    x = relu(x.reshape(*x.shape[:-3], -1))
    ts = dense(p['ts_embedding'], one_hot(obs['time_step'], time_step_dim))
    x = np.concatenate([x, ts, obs['random_z']], -1)
    alpha = 1.0 + softplus(dense(p['fc_alpha'], x))
    beta = 1.0 + softplus(dense(p['fc_beta'], x))
    return alpha, beta, dense(p['critic_head'], x)[..., 0]
