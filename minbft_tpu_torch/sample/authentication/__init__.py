"""Authentication: schemes and the sample authenticators
(port of :mod:`minbft_tpu.sample.authentication`).

:class:`SampleAuthenticator` dispatches signature verification and
own-key signing through the GPU
:class:`minbft_tpu_torch.parallel.BatchVerifier`;
:class:`~.mac.MacAuthenticator` is the pairwise-MAC scheme, its MAC checks
in the engine's HMAC queue.  :class:`~.keystore.KeyStore` is the
keys.yaml (read and written in the reference's layout), and
:func:`~.keystore.generate_testnet_keys` scaffolds a testnet's keys."""

from .authenticator import (
    SampleAuthenticator,
    authenticators_from_keys,
    new_test_authenticators,
)
from .keystore import KeyStore, KeyStoreError, generate_testnet_keys
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
    "KeyStore",
    "KeyStoreError",
    "generate_testnet_keys",
]
