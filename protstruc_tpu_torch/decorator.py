"""Drop-in alias for the reference's ``protstruc.decorator`` module (port of
``protstruc_tpu/decorator.py``).

The reference's ``with_tensor`` converts NumPy arguments to torch and echoes
NumPy back iff no input was a tensor (decorator.py:5-53); ``compat.with_array``
is that decorator over the port, exported here under the reference's name.
"""

from protstruc_tpu_torch.compat import with_array

with_tensor = with_array

__all__ = ["with_tensor", "with_array"]
