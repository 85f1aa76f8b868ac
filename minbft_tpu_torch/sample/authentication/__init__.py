"""Authentication: schemes and the sample authenticators
(port of :mod:`minbft_tpu.sample.authentication`).

:class:`SampleAuthenticator` dispatches signature verification and
own-key signing through the GPU
:class:`minbft_tpu_torch.parallel.BatchVerifier`;
:class:`~.mac.MacAuthenticator` is the pairwise-MAC scheme, its MAC checks
in the engine's HMAC queue.  The keystore and keytool come with a later
slice."""

from .authenticator import (
    SampleAuthenticator,
    authenticators_from_keys,
    new_test_authenticators,
)
from .mac import (
    MacAuthenticator,
    MacKeys,
    mac_authenticators_from_keys,
    mac_keys_from,
    new_test_mac_authenticators,
)

__all__ = [
    "MacAuthenticator",
    "MacKeys",
    "SampleAuthenticator",
    "authenticators_from_keys",
    "mac_authenticators_from_keys",
    "mac_keys_from",
    "new_test_authenticators",
    "new_test_mac_authenticators",
]
