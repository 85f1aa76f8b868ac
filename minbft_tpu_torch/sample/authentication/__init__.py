"""Authentication: schemes and the sample authenticator
(port of :mod:`minbft_tpu.sample.authentication`).

:class:`SampleAuthenticator` dispatches verification and own-key signing
through the GPU :class:`minbft_tpu_torch.parallel.BatchVerifier`.  The
keystore, keytool and MAC authenticator come with a later slice."""

from .authenticator import (
    SampleAuthenticator,
    authenticators_from_keys,
    new_test_authenticators,
)

__all__ = [
    "SampleAuthenticator",
    "authenticators_from_keys",
    "new_test_authenticators",
]
