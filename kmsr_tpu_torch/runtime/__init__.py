from .loader import NativeLoaderUnavailable, NativePatchLoader
