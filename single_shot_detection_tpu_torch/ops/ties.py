"""The bounds of the port's clamps on a gradient path, which take the JAX
package's gradient at a tie: ``jnp.minimum``, ``jnp.maximum`` and
``jnp.clip`` pass half of it at the bound, as ``torch.minimum`` and
``torch.maximum`` do (``torch.clamp`` passes all of it, ``F.relu6``
none).

A bound is a 0-dim CPU tensor: it enters an op on any device and takes the
other operand's dtype, so it costs no launch and no copy.  This module
imports nothing of the port, so that the deploy path, which loads
``ops`` without ``models``, can use it.
"""

import torch

ZERO = torch.tensor(0)
SIX = torch.tensor(6)
