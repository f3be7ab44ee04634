"""The general drivers of the traffic mixes: a mix file names one
(`"driver"`) and gives its parameters."""
